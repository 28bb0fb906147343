"""CUDA-graph replay of the port's per-frame functions.

`tracks/pipeline.process_frame` (two segments around the eager neighbor
gather), `vo/pose.estimate_pose_gn` and `vo/ba.run_ba` are each a fixed
sequence of small kernels (at the benchmark's sizes some 1,600 a frame,
~3,600 a GN call, ~1,900 a BA call), with no host read and every
data-dependent choice a select: on a card the host's dispatch, not the
card, sets their pace.  `Graphed` captures such a function's eager body
once per input signature and replays it: the kernels, their order and
their arithmetic are the eager body's, so a replay returns what the
eager call returns, to the bit.  The caller keeps calling the same
Python function.

The first call of a signature runs the eager body (the warm-up) and
returns its result, then captures the body on static copies of the
tensor arguments.  A later call copies its tensors into them, replays,
and returns a clone of the graph's outputs, so what a call returned
never changes when a later call replays.  A call whose tensors are not
on the current card, or that comes while a stream is capturing, runs
the eager body.  A caller whose shapes change from call to call would
pay a warm-up and a capture on each: it should call the eager body.

`capture` is the one place that touches the card's graph API
(`capture_cuda`); a test passes a plain callable that runs the body on
the same static tensors, which drives the buffer plumbing on the CPU.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from .obs.timing import span

BOUND = 4  # signatures kept per function; each holds its graph's memory pool


def leaves(tree) -> list:
    """The tensors of a nest of NamedTuples and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [x for item in tree for x in leaves(item)]
    return []


def rebuild(tree, it):
    """`tree` with its tensor leaves taken in order from the iterator."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tree._make(rebuild(x, it) for x in tree)
    if isinstance(tree, tuple):
        return tuple(rebuild(x, it) for x in tree)
    return tree


def copy_into(dsts: list, srcs: list) -> None:
    """dst.copy_(src) pair by pair (same shape and dtype), one foreach copy
    per dtype."""
    groups: dict = {}
    for d, s in zip(dsts, srcs, strict=True):
        pair = groups.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


def clone_tree(tree):
    """`tree` with every tensor leaf cloned."""
    src = leaves(tree)
    out = [torch.empty_like(t) for t in src]
    copy_into(out, src)
    return rebuild(tree, iter(out))


def capture_cuda(body: Callable):
    """Capture `body` into a CUDA graph: (replay, its outputs)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    return graph.replay, out


def kernel_switches() -> tuple:
    """The process-wide switches that choose kernels or their precision
    when a body is captured, which a replay cannot change: TF32 for
    matmuls and cuDNN, the float32 matmul precision, deterministic
    algorithms."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
            torch.are_deterministic_algorithms_enabled())


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
        the switches that choose kernels (`kernel_switches`)."""
        tensors = leaves(args)
        dev = tensors[0].device
        if dev.type != self.device_type or any(t.device != dev
                                               for t in tensors):
            return None
        if dev.type == "cuda" and (
                dev.index != torch.cuda.current_device()
                or torch.cuda.is_current_stream_capturing()):
            return None
        return (dev, _shapes(args), kernel_switches())

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
        static = rebuild(args, iter(inputs))
        replay, outputs = self.capture(lambda: self.eager(*static))
        return _Graph(inputs, replay, outputs)
