"""The odometry's solvers (`vo/pose.estimate_pose_gn`, `vo/ba.run_ba`)
replayed as CUDA graphs.

Each solver is a fixed number of Gauss-Newton iterations of small
kernels (at the odometry cell's size ~3,600 a GN call and ~1,900 a BA
call), with no host read and every data-dependent choice a select: on a
card the host's dispatch, not the card, sets its pace.  `Graphed` captures a solver's eager body
once per input signature and replays it: the kernels, their order and
their arithmetic are the eager body's, so a replay returns what the
eager call returns, to the bit.  The caller keeps calling the same
Python function, once per solve.

The first call of a signature runs the eager body (the warm-up) and
returns its result, then captures the body on static copies of the
tensor arguments.  A later call copies its tensors into them, replays,
and returns a clone of the graph's outputs, so what a call returned
never changes when a later call replays.  A call whose tensors are not
on the current card, or that comes while a stream is capturing, runs
the eager body.  A caller whose shapes change from call to call would
pay a warm-up and a capture on each: it should call the eager body.

`capture` is the one place that touches the card's graph API
(`tracks/frame_graph.capture_cuda`); a test passes a plain callable that
runs the body on the same static tensors, which drives the buffer
plumbing on the CPU.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from ..obs.timing import span
from ..tracks.frame_graph import (_kernel_switches, _rebuild, capture_cuda,
                                  clone_tree, copy_into, leaves)

BOUND = 4  # signatures kept per solver; each holds its graph's memory pool


class _Graph(NamedTuple):
    inputs: list  # the static copies of the call's tensors
    replay: Callable
    outputs: object  # the body's result in the graph's memory


def _shapes(tree):
    """`tree` with each tensor replaced by its shape and dtype."""
    if isinstance(tree, torch.Tensor):
        return (tree.shape, tree.dtype)
    if isinstance(tree, tuple):
        return (type(tree), tuple(_shapes(x) for x in tree))
    return tree


class Graphed:
    """`eager(*args)` replayed from the graph of its signature, the `bound`
    most recently used kept.  `args` are tensors, tuples of tensors
    (NamedTuples too), None and hashable Python values; a replayed call
    is recorded in the span `name`.  `capture` records a body
    (`capture_cuda`) on devices of `device_type`."""

    def __init__(self, eager: Callable, name: str,
                 capture: Callable = capture_cuda, device_type: str = "cuda",
                 bound: int = BOUND):
        self.eager, self.name = eager, name
        self.capture, self.device_type, self.bound = (capture, device_type,
                                                      bound)
        self.graphs: OrderedDict = OrderedDict()

    def signature(self, args: tuple):
        """The key of the call's graph, or None where it runs eagerly: the
        device, every Python value, every tensor's shape and dtype, and
        the switches that choose kernels (`_kernel_switches`)."""
        tensors = leaves(args)
        dev = tensors[0].device
        if dev.type != self.device_type or any(t.device != dev
                                               for t in tensors):
            return None
        if dev.type == "cuda" and (
                dev.index != torch.cuda.current_device()
                or torch.cuda.is_current_stream_capturing()):
            return None
        return (dev, _shapes(args), _kernel_switches())

    def __call__(self, *args):
        key = self.signature(args)
        if key is None:
            return self.eager(*args)
        graph = self.graphs.get(key)
        if graph is None:
            out = self.eager(*args)
            self.graphs[key] = self._capture(args)
            while len(self.graphs) > self.bound:
                self.graphs.popitem(last=False)
            return out
        self.graphs.move_to_end(key)
        with span(self.name):
            copy_into(graph.inputs, leaves(args))
            graph.replay()
            return clone_tree(graph.outputs)

    def _capture(self, args: tuple) -> _Graph:
        inputs = [t.clone() for t in leaves(args)]
        static = _rebuild(args, iter(inputs))
        replay, outputs, _ = self.capture(lambda: self.eager(*static))
        return _Graph(inputs, replay, outputs)
