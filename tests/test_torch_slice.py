"""The port's physical-mode slice end to end against the JAX package
(float64, small size: 8 kHz, 0.25 s, one reflection order, 64 bootstrap
draws), the modes once outside the slice (per-bin absorption, the
narrowband solvers, also through the command-line demo) against it too,
the api's refusals (per-bin coefficients, audio-file arguments), and the
command-line demo's device rules."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyaudiolocalization_tpu as jpkg
import pyaudiolocalization_tpu_torch as tpkg
from pyaudiolocalization_tpu_torch import __main__ as tmain


def _config(source=(0.2, 0.6, 0.4), signal_type="chirp"):
    cfg = copy.deepcopy(jpkg.DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25, source_position=list(source),
               signal_type=signal_type)
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               max_reflections=1, num_bootstrap=64,
                               visualize_correlation=False)
    return cfg


@pytest.mark.parametrize("source,signal_type", [((0.2, 0.6, 0.4), "chirp"),
                                                ((0.7, 0.3, 0.2), "noise")])
def test_slice_matches_jax_end_to_end(source, signal_type):
    """Off-centre scenes (non-zero TDOAs).  'noise' signals differ between
    the two PRNGs, so that case injects the JAX package's simulated signals
    into both."""
    cfg = _config(source, signal_type)
    signals = None
    if signal_type == "noise":
        from pyaudiolocalization_tpu.models.simulator import \
            simulate_signals_fast
        import jax
        scene = jpkg.SceneConfig.from_dict(cfg)
        signals = np.asarray(simulate_signals_fast(
            scene.source_position, scene.mic_positions, scene.fs, 343.0,
            scene.duration, "noise", scene.freq, scene.plane_coeffs,
            scene.plane_material_ids, scene.materials.absorption,
            scene.materials.freq, 1, 0.01, key=jax.random.PRNGKey(4),
            dtype=jnp.float64))
    want = jpkg.localize_sound_source(cfg, show_plots=False,
                                      dtype=jnp.float64, signals=signals)
    got = tpkg.localize_sound_source(cfg, device="cpu", dtype=torch.float64,
                                     signals=signals)
    assert set(got) == set(want)
    assert np.any(np.abs(want["tdoas"]) > 0)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got["estimated_position"],
                               want["estimated_position"], rtol=0, atol=1e-3)
    assert set(got["correlation_metrics"]) == set(want["correlation_metrics"])
    for pair, w in want["correlation_metrics"].items():
        g = got["correlation_metrics"][pair]
        assert g["significant"] == w["significant"]
        np.testing.assert_allclose(g["snr"], w["snr"], rtol=1e-7)
        np.testing.assert_allclose(g["peak_to_peak_ratio"],
                                   w["peak_to_peak_ratio"], rtol=1e-7)
    np.testing.assert_allclose(got["uncertainty"]["std"],
                               want["uncertainty"]["std"], rtol=1e-2)
    np.testing.assert_array_equal(got["actual_position"],
                                  want["actual_position"])
    assert got["correlation_matrix"] is None


def test_slice_defaults_to_cpu_and_is_seeded(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)   # visualize_correlation saves figures
    cfg = _config()
    a = tpkg.localize_sound_source(cfg, device="cpu")
    b = tpkg.localize_sound_source(cfg, device="cpu")
    assert a["estimated_position"].dtype == np.float64
    np.testing.assert_array_equal(a["estimated_position"],
                                  b["estimated_position"])
    assert np.linalg.norm(a["estimated_position"] - [0.2, 0.6, 0.4]) < 0.05
    cfg["localization"]["visualize_correlation"] = True
    c = tpkg.localize_sound_source(cfg, device="cpu")
    assert c["correlation_matrix"].shape == (4, 4)


PHYSICAL = {"air": {"absorption": 0.01, "freq": 2e-6},
            "wood": {"absorption": 0.05, "freq": 3e-5},
            "metal": {"absorption": 0.1, "freq": 1e-5}}


def _scene_pair(cfg, materials=None):
    """The JAX package's and the port's scene of ``cfg`` (with a material
    table of their own when ``materials`` is given)."""
    if materials is None:
        return cfg, cfg
    return (jpkg.SceneConfig.from_dict(
                cfg, materials=jpkg.utils.materials.MaterialTable.from_dict(
                    materials)),
            tpkg.SceneConfig.from_dict(
                cfg, materials=tpkg.utils.materials.MaterialTable.from_dict(
                    materials)))


@pytest.mark.parametrize("key,value", [
    ("absorption_mode", "per-bin"),
    ("solver", "beam"), ("solver", "music"), ("solver", "capon")])
def test_modes_outside_the_slice_raise(key, value):
    """Once outside the slice, now ported: per-bin absorption (with
    physically scaled frequency coefficients) and the narrowband solvers
    run on the CPU and match the JAX package — the fix within 1e-6 m
    (per-bin: the TDOAs to 1e-9 s and the fix within 1e-3 m, as the
    slice's own test), the cost and the uncertainty."""
    cfg = _config()
    scene_keys = ("absorption_mode", "signal_type")
    (cfg if key in scene_keys else cfg["localization"])[key] = value
    jscene, tscene = _scene_pair(cfg, PHYSICAL if key in scene_keys
                                 else None)
    want = jpkg.localize_sound_source(jscene, show_plots=False,
                                      dtype=jnp.float64)
    got = tpkg.localize_sound_source(tscene, device="cpu",
                                     dtype=torch.float64)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got["estimated_position"],
                               want["estimated_position"], rtol=0,
                               atol=1e-3 if key in scene_keys else 1e-6)
    np.testing.assert_allclose(got["uncertainty"]["std"],
                               want["uncertainty"]["std"], rtol=1e-2)
    assert got["uncertainty"]["heuristic"] == want["uncertainty"]["heuristic"]
    if key in scene_keys:
        assert np.linalg.norm(got["estimated_position"] - [0.2, 0.6, 0.4]) \
            < 0.02
    else:
        np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-8)


def test_api_refusals():
    """Per-bin absorption with the default (reference-scale) coefficients
    runs, warning that they absorb the band; audio files are read now
    (tests/test_torch_audio_io.py), so a missing one raises
    FileNotFoundError as the JAX package's reader does, and no files at all
    a ValueError."""
    cfg = _config()
    per_bin = dict(cfg, absorption_mode="per-bin")
    with pytest.warns(UserWarning, match="per-bin"):
        res = tpkg.localize_sound_source(per_bin, device="cpu")
    assert np.all(np.isfinite(res["estimated_position"]))
    with pytest.raises(FileNotFoundError):
        tpkg.localize_sound_source(cfg, device="cpu", use_simulation=False,
                                   audio_files=["a.wav"] * 4)
    with pytest.raises(ValueError, match="Audio files must be provided"):
        tpkg.localize_sound_source(cfg, device="cpu", use_simulation=False)


@pytest.mark.parametrize("argv", [
    ["--physical", "--no-calibration", "--no-plots", "--solver", "beam"],
    ["--solver", "music"], ["--no-plots", "--solver", "capon"]])
def test_demo_requires_the_physical_path(argv, monkeypatch):
    """The demo runs the narrowband solvers (on the slice's small scene
    here, figures off): the fix it computes equals the JAX package's on the
    same configuration and calibration data within 1e-6 m."""
    small = _config(signal_type="sine")
    small["localization"]["lag_mode"] = "reference"   # the demo switches it
    monkeypatch.setattr(tmain, "DEFAULT_CONFIG", small)
    api_fn = tmain.localize_sound_source
    seen = {}

    def caught(config, **kw):
        kw["show_plots"] = False
        seen.update(config=config, calibration=kw["calibration_data"],
                    res=api_fn(config, **kw))
        return seen["res"]

    monkeypatch.setattr(tmain, "localize_sound_source", caught)
    assert tmain.main(argv + ["--device", "cpu"]) == 0
    cfg = seen["config"]
    assert cfg["localization"]["solver"] == argv[-1]
    assert cfg["localization"]["lag_mode"] == "physical"
    want = jpkg.localize_sound_source(cfg, show_plots=False,
                                      calibration_data=seen["calibration"],
                                      dtype=jnp.float32)
    np.testing.assert_allclose(seen["res"]["estimated_position"],
                               want["estimated_position"], atol=1e-4)


def test_demo_never_falls_back_to_cpu_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tmain.main(["--physical", "--no-calibration", "--no-plots"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tmain.main(["--physical", "--no-calibration", "--no-plots",
                    "--device", "cuda"])
