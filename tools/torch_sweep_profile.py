"""Device time and idle share of one warm Monte-Carlo sweep of the PyTorch
port on the card, under ``torch.profiler``, at one of ``bench.py``'s
specs:

* ``full`` (default): ``bench_full_sweep``, 4 mics, 44.1 kHz x 1 s,
  noise, SNR 20-40 dB, 512 scenes (the fused K5 path); ``full_split``
  the same scenes through the split path (K3, then K2), which the sweep
  takes where its fused gate does not hold;
* ``reverberant``: ``bench_reverberant_sweep``, six planes at order 2,
  16 kHz x 0.25 s, ``solver='srp'``, 512 scenes (K3, K1, the SRP search);
  ``reverberant_lm`` the same with ``solver='srp+lm'``;
* ``multi_spatial`` / ``multi_claim``: ``bench_multi_source``, an 8-mic
  cube, 2 sources, 128 scenes.

The SRP specs are read from tests/data/torch_srp_golden.json.  Prints the
profiled wall time, the device time summed over kernels (the profiler's
"Self CUDA time total"), the idle share, the number of device kernels,
and the kernels that take the most device time; then the best of three
warm unprofiled runs (host wall clock ending in a synchronize) as
scenes/s.  Run from the repository root on a machine with a card:

    python tools/torch_sweep_profile.py [full|full_split|reverberant|
                                         reverberant_lm|multi_spatial|
                                         multi_claim]
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRP_GOLDEN = REPO / "tests" / "data" / "torch_srp_golden.json"


def _spec(sw, name: str):
    """(SweepSpec, scenes) of the named spec."""
    if name in ("full", "full_split"):
        return sw.SweepSpec(fs=44100.0, duration=1.0, signal_type="noise",
                            source_box_lo=(0.1, 0.1, 0.1),
                            source_box_hi=(0.9, 0.9, 0.9),
                            snr_db=(20.0, 40.0)), 512

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v
    case = json.loads(SRP_GOLDEN.read_text())[name]
    spec = sw.SweepSpec(**{k: tup(v) for k, v in case["spec"].items()})
    return spec, 128 if spec.num_sources > 1 else 512


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_sweep_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from pyaudiolocalization_tpu_torch.parallel import sweep as sw
    name = sys.argv[1] if len(sys.argv) > 1 else "full"
    spec, scenes = _spec(sw, name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; spec {name}, {scenes} scenes", flush=True)

    def sweep(seed):
        if name == "full_split":
            gen = torch.Generator(device="cuda").manual_seed(seed)
            return sw._run_scenes(spec, gen, scenes, torch.float32, False)
        return sw.monte_carlo_sweep(spec, seed, scenes, device="cuda")

    sweep(0)                                                 # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        sweep(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    kernels = sum(e.count for e in events)
    print(f"profiled wall {wall * 1e3:.3f} ms for {scenes} scenes, device "
          f"time {device_us / 1e3:.3f} ms over {kernels} kernels, idle "
          f"{100 * (1 - device_us / 1e6 / wall):.1f} %")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")
    best = float("inf")
    for seed in (2, 3, 4):
        start = time.perf_counter()
        sweep(seed)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - start)
    print(f"warm unprofiled, best of 3: {best * 1e3:.3f} ms, "
          f"{scenes / best:.1f} scenes/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
