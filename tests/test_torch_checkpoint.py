"""The port's checkpointed sweep (parallel/checkpoint.py) and profiling
hooks (utils/profiling.py), the cases of the JAX package's
tests/test_checkpoint.py on the CPU: the checkpoint persists, a resumed run
equals an uninterrupted one to the bit, a checkpoint of another spec, seed
or chunking restarts, an old layout restarts, the arguments are validated;
plus the statistics of a port run against a JAX run of the same spec
(hit rates within 3 binomial sigma), the .npz layout the JAX package
reads, and the stage registry."""

import jax
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.parallel import checkpoint as jck
from pyaudiolocalization_tpu.parallel import monte_carlo_sweep as jsweep
from pyaudiolocalization_tpu.parallel import SweepSpec as JSpec
from pyaudiolocalization_tpu_torch.parallel import (
    SweepSpec, load_checkpoint, run_sweep_checkpointed)
from pyaudiolocalization_tpu_torch.parallel import checkpoint as tck
from pyaudiolocalization_tpu_torch.utils import profiling

ARGS = dict(fs=16000.0, duration=0.05, signal_type="noise",
            source_box_lo=(0.2, 0.2, 0.2), source_box_hi=(0.8, 0.8, 0.8),
            snr_db=(25.0, 35.0))
SPEC = SweepSpec(**ARGS)
CPU = {"device": "cpu"}


def test_checkpointed_sweep_runs_and_persists(tmp_path):
    path = str(tmp_path / "sweep.npz")
    out = run_sweep_checkpointed(SPEC, seed=7, num_scenes=8, chunk_scenes=4,
                                 checkpoint_path=path, **CPU)
    assert out.results.estimate.shape == (8, 3)
    assert isinstance(out.results.estimate, np.ndarray)
    done, chunk, seed, spec_repr, results = load_checkpoint(path)
    assert (done, chunk, seed) == (2, 4, 7)
    assert "16000.0" in spec_repr
    np.testing.assert_array_equal(results.error, out.results.error)
    assert np.isfinite(out.rmse) and 0.0 <= out.hit_rate <= 1.0
    # The JAX package's reader takes the port's file (same fields).
    assert jck.load_checkpoint(path)[:3] == (2, 4, 7)


def test_checkpointed_sweep_resumes_bit_identical(tmp_path):
    full = run_sweep_checkpointed(SPEC, seed=3, num_scenes=12,
                                  chunk_scenes=4,
                                  checkpoint_path=str(tmp_path / "full.npz"),
                                  **CPU)
    # An interruption after chunk 2: a log_fn that raises.
    part = str(tmp_path / "part.npz")

    def stop(msg):
        if msg.startswith("chunk 2/"):
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        run_sweep_checkpointed(SPEC, seed=3, num_scenes=12, chunk_scenes=4,
                               checkpoint_path=part, log_fn=stop, **CPU)
    assert load_checkpoint(part)[0] == 2
    logs = []
    resumed = run_sweep_checkpointed(SPEC, seed=3, num_scenes=12,
                                     chunk_scenes=4, checkpoint_path=part,
                                     log_fn=logs.append, **CPU)
    assert any("resuming at chunk 2" in m for m in logs)
    for a, b in zip(resumed.results, full.results):
        np.testing.assert_array_equal(a, b)
    assert float(resumed.rmse) == float(full.rmse)


def test_checkpoint_mismatched_params_restart(tmp_path):
    """A checkpoint of another chunking, seed or spec is ignored."""
    path = str(tmp_path / "sweep.npz")
    run_sweep_checkpointed(SPEC, seed=1, num_scenes=4, chunk_scenes=4,
                           checkpoint_path=path, **CPU)
    for spec, seed, chunk in ((SPEC, 2, 4), (SPEC, 1, 2),
                              (SweepSpec(**dict(ARGS, signal_type="chirp")),
                               1, 4)):
        logs = []
        out = run_sweep_checkpointed(spec, seed=seed, num_scenes=4,
                                     chunk_scenes=chunk, checkpoint_path=path,
                                     log_fn=logs.append, **CPU)
        assert not any("resuming" in m for m in logs)
        assert out.results.estimate.shape == (4, 3)
    logs = []
    run_sweep_checkpointed(SPEC, seed=1, num_scenes=4, chunk_scenes=4,
                           checkpoint_path=path, resume=False,
                           log_fn=logs.append, **CPU)
    assert not any("resuming" in m for m in logs)


def test_checkpoint_old_layout_restarts(tmp_path):
    """A checkpoint without the covariance field (an older SceneResult
    layout) loads as None: the sweep restarts instead of failing."""
    path = str(tmp_path / "old.npz")
    np.savez(path, estimate=np.zeros((4, 3)), source=np.zeros((4, 3)),
             error=np.zeros(4), cost=np.zeros(4), tdoas=np.zeros((4, 6)),
             completed_chunks=np.asarray(1), chunk_scenes=np.asarray(4),
             seed=np.asarray(1), spec_repr=np.asarray("x"))
    assert load_checkpoint(path) is None
    assert load_checkpoint(str(tmp_path / "absent.npz")) is None
    out = run_sweep_checkpointed(SPEC, seed=1, num_scenes=4, chunk_scenes=4,
                                 checkpoint_path=path, **CPU)
    assert out.results.covariance.shape == (4, 3, 3)


def test_checkpoint_validation(tmp_path):
    with pytest.raises(ValueError, match="multiple"):
        run_sweep_checkpointed(SPEC, seed=0, num_scenes=5, chunk_scenes=4,
                               checkpoint_path=str(tmp_path / "x.npz"), **CPU)
    with pytest.raises(TypeError, match="SceneMesh"):
        run_sweep_checkpointed(SPEC, seed=0, num_scenes=4, chunk_scenes=4,
                               checkpoint_path=str(tmp_path / "x.npz"),
                               mesh=object(), **CPU)


def test_chunk_seeds_are_fixed_and_distinct():
    """The rule of (seed, chunk index) -> generator seed is fixed (a
    resume in another process draws the same chunk) and separates nearby
    seeds and chunks."""
    seeds = {tck.chunk_seed(s, i) for s in range(4) for i in range(4)}
    assert len(seeds) == 16
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert tck.chunk_seed(3, 1) == tck.chunk_seed(3, 1)
    assert tck.chunk_seed(0, 0) == 6375474604893067239


def test_checkpointed_statistics_agree_with_jax(tmp_path):
    """16 scenes on each side (independent draws): hit rates within 3
    binomial sigma of the pooled rate, RMSE of the same order."""
    n = 16
    got = run_sweep_checkpointed(SPEC, seed=5, num_scenes=n, chunk_scenes=8,
                                 checkpoint_path=str(tmp_path / "t.npz"),
                                 **CPU)
    want = jsweep(JSpec(**ARGS), jax.random.PRNGKey(5), n)
    p = (float(got.hit_rate) + float(want.hit_rate)) / 2
    sigma = np.sqrt(p * (1 - p) * 2 / n)
    assert abs(float(got.hit_rate) - float(want.hit_rate)) <= 3 * sigma
    assert float(got.hit_rate) >= 0.75
    assert float(got.rmse) < 0.5 and float(want.rmse) < 0.5


def test_profiling_stage_registry():
    profiling.reset()
    for _ in range(2):
        with profiling.stage("unit-test-stage"):
            pass
    rep = profiling.report()
    assert rep["unit-test-stage"]["calls"] == 2
    assert rep["unit-test-stage"]["total_s"] >= 0.0
    assert rep["unit-test-stage"]["mean_s"] == \
        rep["unit-test-stage"]["total_s"] / 2
    profiling.reset()
    assert "unit-test-stage" not in profiling.report()


def test_throughput_counter():
    c = profiling.ThroughputCounter()
    c.add(10)
    assert c.per_second > 0


def test_stage_is_a_profiler_range_and_trace_to_writes(tmp_path):
    """``stage`` shows in a profiler trace under its name; ``trace_to``
    writes a TensorBoard trace file."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.stage("traced-stage"):
            torch.ones(4).sum()
    assert any(e.key == "traced-stage" for e in prof.key_averages())
    with profiling.trace_to(str(tmp_path)):
        torch.ones(4).sum()
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())
