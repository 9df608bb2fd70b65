"""Device time and idle share of one warm full-width Monte-Carlo sweep of
the PyTorch port (``bench.py``'s ``bench_full_sweep`` spec: 4 mics,
44.1 kHz x 1 s, noise, SNR 20-40 dB, 512 scenes) on the card, under
``torch.profiler``.

Prints the profiled wall time, the device time summed over kernels (the
profiler's "Self CUDA time total"), the idle share, the number of device
kernels, and the kernels that take the most device time.  Run from the
repository root on a machine with a card:

    python tools/torch_sweep_profile.py
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SCENES = 512


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_sweep_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from pyaudiolocalization_tpu_torch.parallel import sweep as sw
    spec = sw.SweepSpec(fs=44100.0, duration=1.0, signal_type="noise",
                        source_box_lo=(0.1, 0.1, 0.1),
                        source_box_hi=(0.9, 0.9, 0.9), snr_db=(20.0, 40.0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sw.monte_carlo_sweep(spec, 0, SCENES, device="cuda")     # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        sw.monte_carlo_sweep(spec, 1, SCENES, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    kernels = sum(e.count for e in events)
    print(f"profiled wall {wall * 1e3:.3f} ms for {SCENES} scenes, device "
          f"time {device_us / 1e3:.3f} ms over {kernels} kernels, idle "
          f"{100 * (1 - device_us / 1e6 / wall):.1f} %")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
