"""The port's scene mesh (parallel/sweep.make_mesh, parallel/multihost.py)
on the CPU: a one-rank mesh equals the checkpointed sweep's single chunk to
the bit, the refusals, and two gloo processes started on a free port whose
shards equal the chunks of the unmeshed checkpointed sweep, with the same
summary on both ranks, and whose meshed checkpointed sweep resumes after a
stop equal to an uninterrupted run, also where only rank 0 sees the
checkpoint."""

import multiprocessing
import os
import socket
import traceback

import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu_torch.parallel import (
    SceneMesh, SweepSpec, load_checkpoint, make_mesh, monte_carlo_sweep,
    multihost, run_sweep_checkpointed)

CUBE = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
        (1.0, 1.0, 0.0), (1.0, 0.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 1.0))
SPEC = SweepSpec(fs=8000.0, duration=0.05, signal_type="noise",
                 source_box_lo=(0.2,) * 3, source_box_hi=(0.8,) * 3)
SPECS = {
    "lm": SPEC,
    "srp_multi": SweepSpec(fs=8000.0, duration=0.05, signal_type="noise",
                           mic_positions=CUBE, solver="srp", num_sources=2,
                           source_min_separation=0.4,
                           source_box_lo=(0.1,) * 3,
                           source_box_hi=(0.9,) * 3, snr_db=(25.0, 35.0)),
}
SEED = 11
SCENES = 16
JOIN_S = 120.0


def _equal(a, b):
    for x, y in zip(a, b):
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_one_rank_mesh_equals_one_chunk(tmp_path, name):
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.axis_name == "scenes"
    out = monte_carlo_sweep(SPECS[name], SEED, 4, mesh=mesh)
    ck = run_sweep_checkpointed(SPECS[name], SEED, 4, 4,
                                str(tmp_path / "c.npz"), device="cpu")
    _equal(out.results, ck.results)
    np.testing.assert_allclose(float(out.rmse), float(ck.rmse), rtol=1e-6)
    assert float(out.hit_rate) == float(ck.hit_rate)


def test_mesh_refusals(tmp_path):
    mesh = make_mesh(device="cpu")
    two = SceneMesh(None, 2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        monte_carlo_sweep(SPEC, SEED, 5, mesh=two)
    with pytest.raises(TypeError, match="int seed"):
        monte_carlo_sweep(SPEC, torch.Generator().manual_seed(0), 4,
                          mesh=mesh)
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        run_sweep_checkpointed(SPEC, SEED, 6, 3, str(tmp_path / "x.npz"),
                               mesh=two)
    assert not multihost.is_multiprocess()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, port, out_dir):
    """One gloo rank: the meshed sweep, then the meshed checkpointed sweep
    stopped after its first chunk and resumed, and uninterrupted."""
    try:
        torch.set_num_threads(2)
        multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
        import torch.distributed as dist
        mesh = multihost.global_scene_mesh(device="cpu")
        out = monte_carlo_sweep(SPEC, SEED, SCENES, mesh=mesh)
        res = {f"shard_{k}": v.numpy() for k, v in
               zip(out.results._fields, out.results)}
        res["summary"] = np.array([float(out.rmse), float(out.mean_error),
                                   float(out.hit_rate)])
        res["multiprocess"] = np.array(multihost.is_multiprocess())
        part = os.path.join(out_dir, "part.npz")

        def stop(msg):
            if msg.startswith("chunk 1/"):
                raise KeyboardInterrupt

        try:
            run_sweep_checkpointed(SPEC, SEED, 2 * SCENES, SCENES, part,
                                   mesh=mesh, log_fn=stop)
        except KeyboardInterrupt:
            pass
        res["stopped_at"] = np.array(load_checkpoint(part)[0])
        logs = []
        resumed = run_sweep_checkpointed(SPEC, SEED, 2 * SCENES, SCENES,
                                         part, mesh=mesh,
                                         log_fn=logs.append)
        res["resumed_log"] = np.array(logs[0])
        # No shared filesystem: each rank has a path of its own, and only
        # rank 0's is ever written, so rank 0 alone decides the resume.
        own = os.path.join(out_dir, f"own{rank}.npz")
        try:
            run_sweep_checkpointed(SPEC, SEED, 2 * SCENES, SCENES, own,
                                   mesh=mesh, log_fn=stop)
        except KeyboardInterrupt:
            pass
        res["own_written"] = np.array(os.path.exists(own))
        logs = []
        own_resumed = run_sweep_checkpointed(SPEC, SEED, 2 * SCENES, SCENES,
                                             own, mesh=mesh,
                                             log_fn=logs.append)
        res["own_resumed_log"] = np.array(logs[0])
        full = run_sweep_checkpointed(
            SPEC, SEED, 2 * SCENES, SCENES,
            os.path.join(out_dir, f"full{rank}.npz"), mesh=mesh)
        for tag, run in (("resumed", resumed), ("own_resumed", own_resumed),
                         ("full", full)):
            for k, v in zip(run.results._fields, run.results):
                res[f"{tag}_{k}"] = v
        dist.destroy_process_group()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' outputs, from two spawned gloo processes joined within
    JOIN_S seconds (a hang fails instead of holding the suite)."""
    out = str(tmp_path_factory.mktemp("mesh"))
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = [open(os.path.join(out, f)).read() for f in sorted(os.listdir(
        out)) if f.endswith(".err")]
    assert not alive, f"gloo ranks still running after {JOIN_S} s"
    assert not errors and all(p.exitcode == 0 for p in procs), errors
    ranks = []
    for r in range(2):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


FIELDS = ("estimate", "source", "error", "cost", "tdoas", "covariance")


def test_two_gloo_ranks_agree_on_the_summary(two_ranks):
    assert all(bool(r["multiprocess"]) for r in two_ranks)
    np.testing.assert_array_equal(two_ranks[0]["summary"],
                                  two_ranks[1]["summary"])
    err = np.concatenate([r["shard_error"] for r in two_ranks])
    np.testing.assert_allclose(two_ranks[0]["summary"],
                               [np.sqrt(np.mean(err ** 2)), np.mean(err),
                                np.mean(err < 0.1)], rtol=1e-6)


def test_two_gloo_ranks_shards_equal_the_chunks(two_ranks, tmp_path):
    ck = run_sweep_checkpointed(SPEC, SEED, SCENES, SCENES // 2,
                                str(tmp_path / "c.npz"), device="cpu")
    half = SCENES // 2
    for r, ranked in enumerate(two_ranks):
        assert ranked["shard_error"].shape == (half,)
        _equal([ranked[f"shard_{k}"] for k in FIELDS],
               [getattr(ck.results, k)[r * half:(r + 1) * half]
                for k in FIELDS])


def test_two_gloo_ranks_checkpoint_resumes(two_ranks, tmp_path):
    """Stopped after chunk 1 of 2, resumed: equal to the uninterrupted
    meshed run on both ranks, and to the unmeshed sweep at chunks of
    SCENES / 2 (the checkpoint's own unit)."""
    unmeshed = run_sweep_checkpointed(SPEC, SEED, 2 * SCENES, SCENES // 2,
                                      str(tmp_path / "u.npz"), device="cpu")
    for ranked in two_ranks:
        assert int(ranked["stopped_at"]) == 2
        assert str(ranked["resumed_log"]) == "resuming at chunk 1/2"
        for tag in ("resumed", "full"):
            _equal([ranked[f"{tag}_{k}"] for k in FIELDS],
                   [getattr(unmeshed.results, k) for k in FIELDS])


def test_two_gloo_ranks_resume_without_a_shared_file(two_ranks, tmp_path):
    """Each rank given its own path, so rank 1 never finds a checkpoint:
    both still resume at rank 0's chunk, equal to the unmeshed sweep."""
    unmeshed = run_sweep_checkpointed(SPEC, SEED, 2 * SCENES, SCENES // 2,
                                      str(tmp_path / "u.npz"), device="cpu")
    assert [bool(r["own_written"]) for r in two_ranks] == [True, False]
    for ranked in two_ranks:
        assert str(ranked["own_resumed_log"]) == "resuming at chunk 1/2"
        _equal([ranked[f"own_resumed_{k}"] for k in FIELDS],
               [getattr(unmeshed.results, k) for k in FIELDS])
