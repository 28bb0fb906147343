"""Per-stage wall-clock timing + profiler hook (counterpart of
obs/timing.py).

CUDA work is launched asynchronously, so a span that observed a result on
a card ends with `torch.cuda.synchronize` of that card; on the CPU there
is nothing to wait for.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any

import torch


def _cuda_devices(tree) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists and
    dicts."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in tree)) if tree else set()
    return set()


class StageTimer:
    """Accumulating named-span timer.

    Usage:
        timer = StageTimer()
        with timer.span("depth"):
            out = timer.observe(estimate_depths(...))   # waited for on exit
        print(timer.report())
    """

    def __init__(self, sync: bool = True):
        self._sync = sync
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._last_result: Any = None

    @contextlib.contextmanager
    def span(self, name: str, result: Any = None):
        start = time.perf_counter()
        try:
            yield self
        finally:
            if self._sync and self._last_result is not None:
                for dev in _cuda_devices(self._last_result):
                    torch.cuda.synchronize(dev)
                self._last_result = None
            self._totals[name] += time.perf_counter() - start
            self._counts[name] += 1

    def observe(self, result: Any) -> Any:
        """Register device values to wait for when the span exits."""
        self._last_result = result
        return result

    def totals(self) -> dict[str, float]:
        return dict(self._totals)

    def report(self) -> str:
        lines = [f"{'stage':32s} {'total s':>10s} {'calls':>7s} {'ms/call':>10s}"]
        for name, total in sorted(self._totals.items(), key=lambda kv: -kv[1]):
            n = self._counts[name]
            lines.append(f"{name:32s} {total:10.3f} {n:7d} {1e3 * total / n:10.3f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler trace of the region (CPU and, where there is a card,
    CUDA activities), written to `logdir` as a Chrome trace."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
