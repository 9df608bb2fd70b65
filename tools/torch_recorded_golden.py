"""Write tests/data/recorded/ and tests/data/torch_recorded_golden.json: the
recorded files that ``chip_smoke.py``'s recorded phase reads through the
PyTorch port on the card, and the JAX package's answers for them.

* ``tests/data/recorded/``: the off-centre scene of the other golden tools
  (``DEFAULT_CONFIG``, a 1 -> 5 kHz chirp at (0.2, 0.6, 0.4), 4 mics, 3
  reflection orders) rendered by the JAX package's physical-mode simulator
  at 48 kHz for 1 s, one mono file a mic: two 16-bit PCM WAVs, one 32-bit
  float WAV and one FLAC (16-bit).  ``files`` records each file's SHA-256,
  so both sides are known to read the same bytes.
* ``channels``: ``read_audio_files`` of the four files at 44.1 kHz (the
  resampler, normalization, compression) in float64, the exact answer
  the card's float32 channels are held to (the JAX package's float32
  resampler is itself up to 1.6e-3 off it: ops/resample.py of the port):
  64 evenly spaced samples of each channel and its norm.
* ``cases``: ``localize_sound_source(audio_files=..., use_simulation=
  False)`` on ``DEFAULT_CONFIG`` in physical mode (``sync_mode='none'``,
  as the slice golden's scenes) and in parity mode (``lag_mode=
  'reference'`` with the pre-sync), each in float64 and float32, in the
  layout of tests/data/torch_parity_golden.json (tools/torch_parity_golden
  ``run_case``: TDOAs, peak margins, position, cost, significance with
  each pair's peak and bootstrap threshold, the sync shifts).
* ``compat``: the JAX package's compat layer in float64 on inputs that
  ``chip_smoke.py`` rebuilds from the same numpy seeds: the speed of
  sound; ``get_time_delays_phat`` at the exact length (11,025 + 11,025
  samples) and at a power of two (16,384 + 16,385 -> 32,768) of a noise
  row and its fractional delay by 0.30 m / c; ``bootstrap_significance``,
  ``perform_significance_test`` and ``compute_cross_correlation_metrics``
  on the power-of-two pair; ``noise_reduction`` of a 44.1 kHz x 1 s noise
  row by the Butterworth cascade through ``filtfilt_sos`` with 'conv' and
  'prefix', and with 'scan' on its first 4,410 samples (64 evenly spaced
  samples and the norm of each).  Float64 here: the card's float32 answer
  is held to the exact one.

Runs on the CPU in a few minutes, in a temporary working directory:

    JAX_PLATFORMS=cpu python tools/torch_recorded_golden.py
"""

from __future__ import annotations

import copy
import functools
import hashlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from pyaudiolocalization_tpu import DEFAULT_CONFIG, api, compat  # noqa: E402
from pyaudiolocalization_tpu.models.simulator import (  # noqa: E402
    simulate_signals_fast)
from pyaudiolocalization_tpu.ops import filters  # noqa: E402
from pyaudiolocalization_tpu.utils.audio_io import (  # noqa: E402
    read_audio_files, write_wav)
from pyaudiolocalization_tpu.utils.config import SceneConfig  # noqa: E402
from pyaudiolocalization_tpu.utils.flac import write_flac  # noqa: E402

OUT = REPO / "tests" / "data" / "torch_recorded_golden.json"
RECORDED = REPO / "tests" / "data" / "recorded"
FILE_FS = 48000
FS = 44100.0
# (file name, format) a mic.
FILES = (("mic1.wav", "pcm16"), ("mic2.wav", "pcm16"),
         ("mic3.wav", "float32"), ("mic4.flac", "flac"))
PROBES = 64
# The compat inputs' numpy seeds (chip_smoke.py rebuilds the same rows).
PAIR_SEED, FILTER_SEED = 21, 22
EXACT_N, POW2_N, SCAN_N = 11025, 16384, 4410
INJECTED_M = 0.30


def probe(x) -> dict:
    """64 evenly spaced samples of a row and its norm."""
    x = np.asarray(x, np.float64)
    idx = np.linspace(0, x.shape[-1] - 1, PROBES).round().astype(int)
    return {"index": idx.tolist(), "samples": x[idx].tolist(),
            "norm": float(np.linalg.norm(x))}


def scene_config() -> dict:
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["source_position"] = [0.2, 0.6, 0.4]
    cfg["signal_type"] = "chirp"
    cfg["localization"]["visualize_correlation"] = False
    return cfg


def write_recorded() -> list:
    """The 48 kHz render of the off-centre scene, one file a mic."""
    scene = SceneConfig.from_dict(scene_config())
    loc = scene.localization
    c = api.acoustics.speed_of_sound_host(scene.celsius, scene.humidity)
    sigs = np.asarray(simulate_signals_fast(
        scene.source_position, scene.mic_positions, float(FILE_FS), c,
        scene.duration, scene.signal_type, scene.freq, scene.plane_coeffs,
        scene.plane_material_ids, scene.materials.absorption,
        scene.materials.freq, loc.max_reflections, loc.absorption_threshold,
        key=jax.random.PRNGKey(scene.seed), dtype=jnp.float64))
    RECORDED.mkdir(parents=True, exist_ok=True)
    paths = []
    for sig, (name, fmt) in zip(sigs, FILES):
        path = RECORDED / name
        if fmt == "flac":
            write_flac(str(path), sig, FILE_FS)
        else:
            write_wav(str(path), sig, FILE_FS,
                      bits=32 if fmt == "float32" else 16)
        paths.append(str(path))
    return paths


def load_parity_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_parity_golden", REPO / "tools" / "torch_parity_golden.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def cases(paths) -> dict:
    """The api from the files, both lag modes, float64 and float32."""
    tool = load_parity_tool()
    physical = scene_config()
    physical["localization"].update(lag_mode="physical", sync_mode="none")
    parity = scene_config()
    parity["localization"]["lag_mode"] = "reference"
    orig = api.localize_sound_source
    api.localize_sound_source = functools.partial(
        orig, audio_files=paths, use_simulation=False)
    out = {}
    try:
        for name, cfg in (("physical", physical), ("parity", parity)):
            out[name] = {"lag_mode": cfg["localization"]["lag_mode"]}
            for tag, dtype in (("float64", jnp.float64),
                               ("float32", jnp.float32)):
                res = tool.run_case(cfg, None, dtype)
                out[name][tag] = res
                print(f"{name} {tag}: {res['seconds']:.1f} s, tdoas "
                      f"{res['tdoas']}, margins {res['margins']}, position "
                      f"{res['estimated_position']}", flush=True)
    finally:
        api.localize_sound_source = orig
    return out


def compat_cases() -> dict:
    c = compat.speed_of_sound(20.0, 50.0)
    rng = np.random.default_rng(PAIR_SEED)
    row = rng.standard_normal(POW2_N)
    delay = INJECTED_M / c
    out = {"speed_of_sound": c, "injected_delay_s": delay}
    exact = row[:EXACT_N]
    exact_delayed = compat.fractional_delay(exact, delay, FS)
    pow2_delayed = np.append(compat.fractional_delay(row, delay, FS), 0.0)
    for name, (a, b) in (("exact", (exact, exact_delayed)),
                         ("pow2", (row, pow2_delayed))):
        delays, corr, _ = compat.get_time_delays_phat(a, b, FS,
                                                      lag_mode="physical")
        out[f"delays_{name}"] = [float(d) for d in delays]
        out[f"corr_peak_{name}"] = float(np.max(corr))
    compat.seed(0)
    out["bootstrap_threshold"] = compat.bootstrap_significance(
        row, pow2_delayed, FS)
    corr = compat.phat_correlation(row, pow2_delayed)
    snr, significant = compat.perform_significance_test(corr, row,
                                                        pow2_delayed, FS)
    out["significance_test"] = {"snr": snr, "significant": significant}
    out["metrics"] = compat.compute_cross_correlation_metrics(
        corr, row, pow2_delayed, FS)
    x = np.random.default_rng(FILTER_SEED).standard_normal(int(FS))
    out["noise_reduction"] = {
        m: probe(filters.noise_reduction(jnp.asarray(x if m != "scan"
                                                     else x[:SCAN_N]), FS,
                                         lfilter_method=m))
        for m in ("conv", "prefix", "scan")}
    return out


def main() -> int:
    os.chdir(tempfile.mkdtemp(prefix="torch_recorded_golden_"))
    start = time.perf_counter()
    paths = write_recorded()
    files = [{"name": name, "format": fmt,
              "sha256": hashlib.sha256(Path(p).read_bytes()).hexdigest(),
              "bytes": Path(p).stat().st_size}
             for p, (name, fmt) in zip(paths, FILES)]
    channels = [probe(s) for s in read_audio_files(paths, FS,
                                                   dtype=jnp.float64)]
    golden = {"source": "pyaudiolocalization_tpu (JAX %s, CPU)"
                        % jax.__version__,
              "file_fs": FILE_FS, "fs": FS, "files": files,
              "channels": channels, "cases": cases(paths),
              "compat": compat_cases()}
    OUT.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {OUT} and {len(paths)} files in "
          f"{time.perf_counter() - start:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
