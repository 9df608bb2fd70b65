"""The PyTorch port's host-side foundations against the JAX package:
config and materials, FFT lengths, signal generators, acoustics and the
delay-and-sum render (plain path, float64, rtol 1e-7), plus the no-jax
import contract."""

import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import acoustics as jac
from pyaudiolocalization_tpu.ops import delay as jdelay
from pyaudiolocalization_tpu.ops import fftutils as jfft
from pyaudiolocalization_tpu.ops import signal as jsig
from pyaudiolocalization_tpu.utils import config as jcfg
from pyaudiolocalization_tpu.utils import materials as jmat
from pyaudiolocalization_tpu_torch.models import acoustics as tac
from pyaudiolocalization_tpu_torch.ops import delay as tdelay
from pyaudiolocalization_tpu_torch.ops import fftutils as tfft
from pyaudiolocalization_tpu_torch.ops import signal as tsig
from pyaudiolocalization_tpu_torch.utils import config as tcfg
from pyaudiolocalization_tpu_torch.utils import materials as tmat


@pytest.fixture(scope="module")
def rng():
    """This module's own generator, seeded as the conftest's session-wide
    one: drawing from that one would move the inputs of every later test
    file in the same worker (``test_pallas_fft.py``'s among them)."""
    return np.random.default_rng(1234)


RTOL = 1e-7  # deterministic float64 modules
REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64


def _close(got, want, rtol=RTOL, atol_scale=1e-9):
    want = np.asarray(want)
    atol = atol_scale * max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


def test_default_config_and_materials_equal_jax():
    assert tcfg.DEFAULT_CONFIG == jcfg.DEFAULT_CONFIG
    assert tmat.material_properties == jmat.material_properties
    t = tcfg.SceneConfig.from_dict(tcfg.DEFAULT_CONFIG)
    j = jcfg.SceneConfig.from_dict(jcfg.DEFAULT_CONFIG)
    for field in dataclasses.fields(j):
        a, b = getattr(t, field.name), getattr(j, field.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif isinstance(b, jmat.MaterialTable):
            assert a.names == b.names and dict(a.ids) == dict(b.ids)
            np.testing.assert_array_equal(a.absorption, b.absorption)
            np.testing.assert_array_equal(a.freq, b.freq)
        else:
            assert dataclasses.asdict(a) == dataclasses.asdict(b) \
                if dataclasses.is_dataclass(b) else a == b
    assert t.mic_pairs == j.mic_pairs


@pytest.mark.parametrize("mode", ["exact", "pow2", "circular"])
@pytest.mark.parametrize("n1,n2", [(1, 1), (2000, 2000), (44100, 44100),
                                   (100, 37)])
def test_fft_length_matches_jax(mode, n1, n2):
    assert tfft.fft_length(n1, n2, mode) == jfft.fft_length(n1, n2, mode)
    assert tfft.next_pow2(n1) == jfft.next_pow2(n1)


@pytest.mark.parametrize("kind", ["sine", "chirp"])
def test_generate_signal_matches_jax(kind):
    fs, dur, freq = 8000.0, 0.25, 700.0
    want = jsig.generate_signal(kind, fs, dur, freq, dtype=jnp.float64)
    got = tsig.generate_signal(kind, fs, dur, freq, dtype=F64)
    _close(got, want)
    # The simulator passes the carrier as a 0-d tensor.
    got_t = tsig.generate_signal(kind, fs, dur, torch.tensor(freq, dtype=F64),
                                 dtype=F64)
    _close(got_t, want)


def test_noise_signal_needs_generator_and_is_seeded():
    with pytest.raises(ValueError, match="Generator"):
        tsig.generate_signal("noise", 8000.0, 0.1, 1.0)
    a = tsig.generate_signal("noise", 8000.0, 0.1, 1.0,
                             generator=torch.Generator().manual_seed(3))
    b = tsig.generate_signal("noise", 8000.0, 0.1, 1.0,
                             generator=torch.Generator().manual_seed(3))
    assert a.shape == (800,) and torch.equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        tsig.generate_signal("speech", 8000.0, 0.1, 1.0)


def test_normalize_and_compression_match_jax(rng):
    x = rng.standard_normal((3, 500)) * np.array([[1.0], [1e-3], [0.0]])
    _close(tsig.normalize_signal(torch.from_numpy(x)),
           jsig.normalize_signal(jnp.asarray(x)))
    _close(tsig.dynamic_range_compression(torch.from_numpy(x)),
           jsig.dynamic_range_compression(jnp.asarray(x)))


def _materials(physical: bool):
    props = copy.deepcopy(jmat.material_properties)
    if physical:  # small coefficients, so image sources are accepted
        props = {"air": {"absorption": 0.01, "freq": 1e-6},
                 "wood": {"absorption": 0.05, "freq": 2e-6},
                 "metal": {"absorption": 0.1, "freq": 1e-6}}
    return jmat.MaterialTable.from_dict(props)


@pytest.mark.parametrize("physical", [False, True])
@pytest.mark.parametrize("order", [1, 3])
def test_image_sources_match_jax(physical, order):
    table = _materials(physical)
    planes = np.array([[1, 0, 0, -5], [0, 1, 0, -5], [0, 0, 1, -5.0]])
    ids = np.array([table.ids["wood"], table.ids["metal"],
                    table.ids["wood"]])
    mics = np.array(jcfg.DEFAULT_CONFIG["mic_positions"], float)
    src = np.array([0.2, 0.6, 0.4])
    want = jac.image_sources(jnp.asarray(src), jnp.asarray(planes),
                             jnp.asarray(ids), jnp.asarray(mics), 1000.0,
                             jnp.asarray(table.absorption),
                             jnp.asarray(table.freq), order, 0.01)
    got = tac.image_sources(torch.from_numpy(src), torch.from_numpy(planes),
                            torch.from_numpy(ids), torch.from_numpy(mics),
                            1000.0, torch.from_numpy(table.absorption),
                            torch.from_numpy(table.freq), order, 0.01)
    _close(got.positions, want.positions)
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    np.testing.assert_array_equal(got.material_ids.numpy(),
                                  np.asarray(want.material_ids))
    np.testing.assert_array_equal(got.orders.numpy(), np.asarray(want.orders))
    assert bool(np.any(want.accepted)) == physical
    tree_t, tree_j = tac.reflection_tree(3, order), jac.reflection_tree(3,
                                                                        order)
    for a, b in zip(tree_t, tree_j):
        np.testing.assert_array_equal(a, b)


def test_attenuation_and_speed_of_sound_match_jax(rng):
    d = rng.uniform(0.05, 12.0, 40)
    mid = rng.integers(0, 3, 40)
    table = _materials(True)
    for name in ("log_attenuation", "calculate_attenuation"):
        want = getattr(jac, name)(jnp.asarray(d), jnp.asarray(mid), 1000.0,
                                  jnp.asarray(table.absorption),
                                  jnp.asarray(table.freq))
        got = getattr(tac, name)(torch.from_numpy(d), torch.from_numpy(mid),
                                 1000.0, torch.from_numpy(table.absorption),
                                 torch.from_numpy(table.freq))
        _close(got, want)
    for t, h in [(20, 50), (-80, 120), (35.5, 10)]:
        assert tac.speed_of_sound_host(t, h) == jac.speed_of_sound_host(t, h)


def test_fade_window_and_delay_and_sum_match_jax(rng):
    fs, n = 8000.0, 1500
    _close(tdelay.fade_window(n, dtype=F64), jdelay.fade_window(n))
    base = rng.standard_normal(n)
    delays = rng.uniform(0.0, 0.05, (3, 4))
    gains = rng.uniform(0.1, 1.0, (3, 4))
    for fade in (True, False):
        want = jdelay.delay_and_sum(jnp.asarray(base), jnp.asarray(delays),
                                    jnp.asarray(gains), fs, apply_fade=fade,
                                    pad_mode="pow2-circular")
        got = tdelay.delay_and_sum(torch.from_numpy(base),
                                   torch.from_numpy(delays),
                                   torch.from_numpy(gains), fs,
                                   apply_fade=fade)
        _close(got, want)
    # The other pad modes: tests/test_torch_parity.py.
    with pytest.raises(ValueError, match="pad_mode"):
        tdelay.delay_and_sum(torch.from_numpy(base),
                             torch.from_numpy(delays),
                             torch.from_numpy(gains), fs, pad_mode="bogus")


def test_port_imports_without_jax():
    """Every module of the port (the compat layer, the audio reader, the
    resampler, the checkpointed sweep, the profiling hooks, tracking, the
    online localizer, array calibration and the mesh named), the
    numpy scene builder that ``chip_smoke.py`` loads from
    tools/torch_sweep_golden.py, K10's A/B bench
    (tools/torch_rowdft_bench.py), phase 12's scene helpers
    (tools/torch_extraction_golden.py) and phase 13's tools (the
    evaluation sweep, tools/torch_eval_sweep.py, and the kernel-path
    fuzz, tools/torch_path_fuzz.py) import with jax blocked."""
    code = (
        "import sys, pkgutil, importlib, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "import pyaudiolocalization_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('compat', 'utils.audio_io', 'utils.flac', "
        "'utils.vorbis', 'ops.resample', 'parallel.checkpoint', "
        "'utils.profiling', 'models.tracking', 'models.online', "
        "'models.arraycal', 'parallel.multihost'):\n"
        "    assert pkg.__name__ + '.' + name in names, name\n"
        "spec = importlib.util.spec_from_file_location('golden', "
        "'tools/torch_sweep_golden.py')\n"
        "tool = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(tool)\n"
        "sigs, _ = tool.batch_scenes(0, 2, 8000.0, 0.05, tool.MICS, 343.0, "
        "(0.2,) * 3, (0.8,) * 3)\n"
        "assert sigs.shape == (2, 4, 400)\n"
        "spec = importlib.util.spec_from_file_location('rowdft_bench', "
        "'tools/torch_rowdft_bench.py')\n"
        "bench = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(bench)\n"
        "assert len(bench.SHAPES) == 5 and callable(bench.run)\n"
        "spec = importlib.util.spec_from_file_location('xgolden', "
        "'tools/torch_extraction_golden.py')\n"
        "xtool = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(xtool)\n"
        "assert len(xtool.extraction_scenes()) == 3\n"
        "assert xtool.true_geometries()[1].shape == (6, 3)\n"
        "tools = {}\n"
        "for tname in ('torch_eval_sweep', 'torch_path_fuzz'):\n"
        "    spec = importlib.util.spec_from_file_location("
        "tname, 'tools/' + tname + '.py')\n"
        "    tools[tname] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(tools[tname])\n"
        "assert len(tools['torch_eval_sweep'].sweep_rows('nees')) == 3\n"
        "assert len(tools['torch_path_fuzz'].configs()) >= 10\n"
        "assert not any(k == 'pyaudiolocalization_tpu' or "
        "k.startswith('pyaudiolocalization_tpu.') for k in sys.modules)\n"
        "assert sys.modules['jax'] is None\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = int(proc.stdout.strip())
    assert names >= 20, names


@pytest.mark.parametrize("name", ["flac.py", "vorbis.py"])
def test_numpy_decoders_are_equal_copies(name):
    """utils/flac.py and utils/vorbis.py are numpy-only: the port carries
    them as copies, equal to the JAX package's files byte for byte."""
    port = (REPO / "pyaudiolocalization_tpu_torch" / "utils" / name)
    jax_side = (REPO / "pyaudiolocalization_tpu" / "utils" / name)
    assert port.read_bytes() == jax_side.read_bytes()


def test_scalar_helpers_match_jax(rng):
    """speed_of_sound (with its clamps) and distance as tensor functions,
    fractional_delay and the soft clip, float64 within 1e-12 relative."""
    temps = np.array([20.0, -60.0, 35.5, 80.0])
    hums = np.array([50.0, 10.0, 120.0, -5.0])
    _close(tac.speed_of_sound(torch.tensor(temps), torch.tensor(hums), 99.0),
           jac.speed_of_sound(jnp.asarray(temps), jnp.asarray(hums), 99.0),
           rtol=1e-12)
    assert tac.speed_of_sound(20.0, 50.0).dtype == torch.get_default_dtype()
    p, q = rng.standard_normal((5, 3)), rng.standard_normal((5, 3))
    _close(tac.distance(torch.tensor(p), torch.tensor(q)),
           jac.distance(jnp.asarray(p), jnp.asarray(q)), rtol=1e-12)
    x = rng.standard_normal(700)
    for delay in (0.0, 3.7 / 8000.0, -2.2 / 8000.0):
        _close(tdelay.fractional_delay(torch.tensor(x), delay, 8000.0),
               jdelay.fractional_delay(jnp.asarray(x), delay, 8000.0),
               rtol=1e-12, atol_scale=1e-12)
    for thr in (0.8, 0.3):
        _close(tsig.dynamic_range_compression_soft_clip(torch.tensor(x), thr),
               jsig.dynamic_range_compression_soft_clip(jnp.asarray(x), thr),
               rtol=1e-12)
