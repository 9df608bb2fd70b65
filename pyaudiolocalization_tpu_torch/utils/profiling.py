"""Stage annotations and throughput counters (counterpart of the JAX
package's utils/profiling.py; the reference has none).

``stage(name)`` opens a ``torch.profiler.record_function`` range (visible
in a captured profiler trace) and adds the host wall clock of its block to
a process-wide registry.  It does not synchronize: CUDA work is
asynchronous, so on a card the time is the enqueue plus whatever
synchronization the block itself performs; end the block with a blocking
read (or ``torch.cuda.synchronize()``) to time the device's work.
``trace_to(dir)`` captures a full profile in TensorBoard's format.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Annotate and time a pipeline stage (host wall clock, no
    synchronize)."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    with _lock:
        _totals[name] += dt
        _counts[name] += 1


def report() -> Dict[str, Dict[str, float]]:
    """{stage: {'total_s', 'calls', 'mean_s'}} accumulated so far."""
    with _lock:
        return {
            name: {
                "total_s": _totals[name],
                "calls": _counts[name],
                "mean_s": _totals[name] / max(_counts[name], 1),
            }
            for name in sorted(_totals)
        }


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


class ThroughputCounter:
    """Scenes/s (or pairs/s) counter for sweep loops."""

    def __init__(self) -> None:
        self._items = 0
        self._start = time.perf_counter()

    def add(self, n: int) -> None:
        self._items += n

    @property
    def per_second(self) -> float:
        dt = time.perf_counter() - self._start
        return self._items / dt if dt > 0 else 0.0


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[None]:
    """Capture a full profile (CPU and, with a card, CUDA activity) into
    ``log_dir`` in TensorBoard's format."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield
