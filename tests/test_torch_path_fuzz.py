"""tools/torch_path_fuzz.py on the CPU: its drawn configurations span what
the tool promises (mic counts, sampling rates, transform lengths, rooms,
solvers), and, with the wrappers' CUDA branch forced and the kernel library
stubbed as tests/test_torch_routing.py does it, each configuration's card
half launches the kernels its ``route`` names with that route's schedule,
and together they reach every sweep route the card runs: K5 fused, K3 then
K2 on the split, K1 in one block, on the split with ``gcc_rows`` and
through its mic rows' spectra in one block (11 mics at 4,096) and on the
split (64 mics at 65,536), K2 / K3 / K5 in one block at nfft <= 4,096
and K2 / K5's GCC through the spectra in one block where a scene's rows
do not fit one (12 mics at 4,096), and K4a + K9 on a single pair,
both on their split up to 2^22 (n1 = 2,048 at 2^21 and 2^22).  The
stubbed kernels write nothing, so the
solver tails downstream of them are stubbed too; the fuzz's plain half and
its comparisons run on the card only."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from pyaudiolocalization_tpu_torch.models import tdoa as ttdoa
from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
from pyaudiolocalization_tpu_torch.parallel import sweep as tsw

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "torch_path_fuzz", REPO / "tools" / "torch_path_fuzz.py")
fz = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fz)
CONFIGS = fz.configs()

# Positions of (nfft, n1, ...) in each wrapper's launch arguments.
SCHEDULE_ARGS = {"fft_real": (3, 4), "whitened_corr": (3, 4),
                 "gcc_all_pairs": (4, 5, 6), "gcc_windowed": (4, 5, 6),
                 "delay_sum": (7, 8), "scene_windowed": (7, 8, 9, 10)}


class _StubLibrary:
    def __getattr__(self, name):
        return name


@pytest.fixture
def launches(monkeypatch):
    """(name, args) of every launch, the CUDA branch forced on CPU tensors,
    scratch shrunk to a stub, and the steps after the kernels (the
    solvers, the ladder) returning zeros of their shapes."""
    calls = []

    def launch(name, device, entry, *args):
        cf.LAUNCHES[name] += 1
        calls.append((name, args))

    def solve_window(spec, win, stats, mics, c, generator,
                     seed_indices=None):
        b = win.shape[0]
        return torch.zeros(b, 3), torch.zeros(b), torch.zeros(win.shape[:2])

    def ladder(corr, *args, **kwargs):
        lead = corr.shape[:-1]
        return ttdoa.TdoaResult(torch.zeros(lead + (1,)),
                                torch.ones(lead + (1,), dtype=torch.bool),
                                corr, torch.zeros(corr.shape[-1]))

    monkeypatch.setattr(cf, "_use_plain", lambda *tensors: False)
    monkeypatch.setattr(cf, "_library", _StubLibrary)
    monkeypatch.setattr(cf, "_launch", launch)
    monkeypatch.setattr(cf, "_scratch", lambda rows, nfft, device:
                        torch.empty((1, 1, 2), device=device))
    monkeypatch.setattr(tsw, "_solve_from_window", solve_window)
    monkeypatch.setattr(tsw, "_solve_srp", lambda spec, corr, mics, td, c: (
        torch.zeros(corr.shape[0], 3), torch.zeros(corr.shape[0])))
    monkeypatch.setattr(ttdoa, "time_delays_from_corr", ladder)
    cf.reset_launches()
    yield calls
    cf.reset_launches()


def test_configurations_span_the_promised_ranges():
    sweeps = [c for c in CONFIGS if c["kind"] == "sweep"]
    pairs = [c for c in CONFIGS if c["kind"] == "pair"]
    assert len(CONFIGS) >= 10
    mics = {len(c["mic_positions"]) for c in sweeps}
    assert set(range(2, 13)) - mics <= {10} and 64 in mics
    assert any(m % 2 for m in mics)
    assert {c["fs"] for c in CONFIGS} == {8000.0, 16000.0, 44100.0, 48000.0}
    nffts = {fz.sweep_spec(c).nfft for c in sweeps}
    assert min(nffts) == 512 and max(nffts) == 131072
    assert max(c["nfft"] for c in pairs) == 1 << 22
    assert {c["room"] for c in sweeps} == {False, True}
    assert {c["solver"] for c in sweeps} == {"lm", "srp"}
    assert fz.configs() == CONFIGS                  # a fixed draw


@pytest.mark.parametrize("index", range(len(CONFIGS)))
def test_card_half_launches_its_route(launches, index):
    """The card half of configuration ``index`` launches exactly the
    kernels of its route, each with the route's transform and schedule
    (the fused and the split estimate: K5 once, K3 and K2 or K1 once)."""
    cfg = CONFIGS[index]
    route = fz.route(cfg)
    if cfg["kind"] == "pair":
        fz.card_pair(cfg, "cpu")
    else:
        _, _, paths, _ = fz.card_sweep(cfg, "cpu")
        assert ("fused" in paths) == ("scene_windowed" in route)
    assert {n for n, _ in launches} == set(route)
    for name, args in launches:
        want = route[name][:-1]
        assert tuple(args[i] for i in SCHEDULE_ARGS[name]) == want, name


def test_configurations_reach_every_sweep_route():
    routes = [fz.route(c) for c in CONFIGS]

    def stages(kernel):
        return {(r[kernel][0], r[kernel][-1]) for r in routes
                if kernel in r}

    k5 = stages("scene_windowed")
    assert any(n <= 4096 and lab == "fused block/block" for n, lab in k5)
    assert any(n <= 4096 and lab == "fused block/spectra block"
               for n, lab in k5)
    assert any(label.startswith("fused split") for _, label in k5)
    for kernel in ("delay_sum", "gcc_windowed"):
        labels = stages(kernel)
        assert any(n <= 4096 and lab == "block" for n, lab in labels)
        assert any(lab.startswith("split") for _, lab in labels)
    # Where a scene's rows do not fit one block at <= 4,096, K2's GCC
    # goes through the mic rows' spectra in one block; nothing of K1, K2,
    # K3 or K5 runs the radix-2 passes.
    assert (4096, "spectra block") in stages("gcc_windowed")
    for kernel in ("delay_sum", "gcc_windowed", "gcc_all_pairs",
                   "scene_windowed"):
        assert not any("passes" in lab for _, lab in stages(kernel))
    k1 = {lab.split()[0] for _, lab in stages("gcc_all_pairs")}
    assert k1 == {"block", "split", "spectra"}
    assert (4096, "spectra block") in stages("gcc_all_pairs")  # 11 mics
    assert (65536, "spectra 256") in stages("gcc_all_pairs")   # 64 mics
    k4a = stages("fft_real")
    assert (1 << 21, "split 2048") in k4a and (1 << 22, "split 2048") in k4a
    assert {lab.split()[0] for _, lab in k4a} == {"block", "split"}
    k9 = stages("whitened_corr")
    assert (1 << 20, "split 1024") in k9
    assert (1 << 21, "split 2048") in k9 and (1 << 22, "split 2048") in k9
    assert not any(lab == "passes" for _, lab in k9)
