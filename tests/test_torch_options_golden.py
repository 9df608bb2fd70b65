"""The port's options path at full width on the CPU (float32, the kernels'
plain twins) against tests/data/torch_options_golden.json, the JAX
package's answers that ``chip_smoke.py`` holds the card to (written by
tools/torch_options_golden.py): TDOAs within 0.05 samples, positions within
5 mm.  The no-gate case runs 64 bootstrap draws instead of 1000: the null
only decides ``significant``, which the golden does not record, and the
TDOAs and the fix do not depend on it."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu_torch import localize_sound_source
from pyaudiolocalization_tpu_torch.models import acoustics, tdoa
from pyaudiolocalization_tpu_torch.models.simulator import \
    simulate_signals_fast
from pyaudiolocalization_tpu_torch.utils.config import SceneConfig

GOLDEN = json.loads((Path(__file__).resolve().parent / "data"
                     / "torch_options_golden.json").read_text())
CASES = GOLDEN["cases"]


def _rendered(cfg):
    scene = SceneConfig.from_dict(cfg)
    loc = scene.localization
    c = acoustics.speed_of_sound_host(scene.celsius, scene.humidity)
    return simulate_signals_fast(
        scene.source_position, scene.mic_positions, scene.fs, c,
        scene.duration, scene.signal_type, scene.freq, scene.plane_coeffs,
        scene.plane_material_ids, scene.materials.absorption,
        scene.materials.freq, loc.max_reflections, loc.absorption_threshold,
        generator=torch.Generator().manual_seed(0), dtype=torch.float32,
        device="cpu", absorption_mode=scene.absorption_mode)


@pytest.mark.parametrize("name", ["weighted", "no_gate"])
def test_options_cases_match_the_golden(name):
    case = CASES[name]
    cfg = case["config"]
    cfg["localization"]["num_bootstrap"] = 64
    res = localize_sound_source(cfg, device="cpu", dtype=torch.float32,
                                calibration_data=case.get("calibration_data"))
    fs = cfg["fs"]
    np.testing.assert_allclose(res["tdoas"], case["tdoas"], rtol=0,
                               atol=0.05 / fs)
    assert np.linalg.norm(res["estimated_position"]
                          - np.asarray(case["estimated_position"])) < 5e-3
    if name == "no_gate":
        assert np.linalg.norm(res["estimated_position"]
                              - np.asarray(case["calibration_target"])) < 5e-3


@pytest.mark.parametrize("scene", ["default", "off_centre"])
def test_single_pair_matches_the_golden(scene):
    case = CASES["single_pair"][scene]
    sigs = _rendered(case["config"])
    fs = case["config"]["fs"]
    for nfft in (None, 65536):
        got = tdoa.get_time_delays_phat(sigs[0], sigs[1], fs,
                                        lag_mode="physical", nfft=nfft)
        want = case["delays"][f"nfft_{nfft or 'exact'}"]
        assert abs(float(got.delays[0]) - want) * fs < 0.05
