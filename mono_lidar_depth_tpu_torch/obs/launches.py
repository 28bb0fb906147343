"""Launch counts of the port's hand-written kernels, by the kernels'
names.  Each kernel wrapper adds one to its module's counter where it
launches its kernel (on a card only: the plain versions on the CPU count
nothing); a script reads them around each of its stages."""

from __future__ import annotations

from ..core import depth_cascade, neighbors, windows
from ..tracker import klt


def kernel_launches() -> dict:
    """The five counters now, by kernel name."""
    return {"gather_neighbors": neighbors.launches,
            "depth_cascade": depth_cascade.launches,
            "lk_track": klt.launches, "zncc_gate": klt.gate_launches,
            "slice_windows": windows.launches}


def launches_since(before: dict) -> dict:
    """Launches of each kernel since `before` (a `kernel_launches()`)."""
    return {k: v - before[k] for k, v in kernel_launches().items()}
