"""`process_frame` (tracks/pipeline.py) replayed as two CUDA graphs around
the neighbor gather.

The eager frame is some 1,600 small kernels, each launched by the host,
and the host, not the card, sets its pace.  With no host sync in the
frame and every data-dependent choice a select, the whole frame can be
captured once and replayed: graph A holds the ground plane, the track
matching and the rasterization, graph B the depth cascade, the table
update and the counters.  Between them the hand-written gather
(`core/depth_estimator.depth_pair_gather`, csrc/gather_neighbors.cu)
stays one eager launch, a Python call of its own per frame.  The kernels,
their order and their arithmetic are those of the eager body; only the
host's per-op dispatch goes.

A `FrameGraph` belongs to one input signature (`FrameGraphs.signature`)
and holds the static tensors the graphs read:

  * copied in on every call: the frame's tensors and `lidar_to_cam`'s;
  * the state's tensors that the graphs read (the track table, the last
    ground plane's `coeffs` and `ok`, the counters): copied in, unless
    they are the very tensors this graph returned last, which graph B's
    tail has already copied back into them.  The last frame's raster is
    read by the eager gather where it lies;
  * the gather's outputs, copied in between the graphs.

What a call returns is cloned out of the graphs' memory, so it never
changes when a later frame runs.  The first frame of a signature runs the
eager body (the warm-up; its gather's outputs become graph B's static
inputs), then captures both graphs outside any frame record.

`capture` is the one place that touches the card's graph API; a test
passes a plain callable that runs the body on the same static tensors,
which drives the buffer plumbing on the CPU.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import torch

from ..core.depth_estimator import depth_pair_cascade, depth_pair_gather
from ..obs.timing import span

BOUND = 4  # signatures kept; each holds its graphs' memory pool


def leaves(tree) -> list:
    """The tensors of a nest of NamedTuples and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [x for item in tree for x in leaves(item)]
    return []


def _rebuild(tree, it):
    """`tree` with its tensor leaves taken in order from the iterator."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tree._make(_rebuild(x, it) for x in tree)
    if isinstance(tree, tuple):
        return tuple(_rebuild(x, it) for x in tree)
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
    return _rebuild(tree, iter(out))


def capture_cuda(body: Callable, pool=None):
    """Capture `body` into a CUDA graph: (replay, its outputs, the memory
    pool, for the next graph to share)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = body()
    return graph.replay, out, graph.pool()


def _kernel_switches() -> tuple:
    """The process-wide switches that choose kernels or their precision
    when a body is captured, which a replay cannot change: TF32 for
    matmuls and cuDNN, the float32 matmul precision, deterministic
    algorithms."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
            torch.are_deterministic_algorithms_enabled())


def _frame_tensors(lidar_to_cam, frame, rng_used: bool) -> list:
    """The frame's tensors that the graphs read, in a fixed order."""
    out = [lidar_to_cam.rotation, lidar_to_cam.translation, frame.cloud,
           frame.cloud_valid, frame.ids, frame.ids_valid, frame.uv_new,
           frame.uv_prev, frame.stamp]
    if frame.semantic is not None:
        out.append(frame.semantic)
    if rng_used:
        out.extend(frame.rng)
    return out


def _state_tensors(state) -> list:
    """The state's tensors that the graphs read."""
    return [*state.table, state.gp_last.coeffs, state.gp_last.ok,
            state.counters]


class FrameGraph:
    """The two graphs of one signature, their static tensors and the state
    they returned last."""

    def __init__(self, graphs: "FrameGraphs", cfg, camera, rng_used: bool):
        self.graphs, self.cfg, self.camera = graphs, cfg, camera
        self.rng_used = rng_used
        self.replay_a = None  # captured on the first call
        self.returned: tuple = ()

    def __call__(self, lidar_to_cam, state, frame):
        if self.replay_a is None:
            return self._warm_up_and_capture(lidar_to_cam, state, frame)
        with span("assoc.frame", frame=True), span("assoc.replay"):
            copy_into(self.frame_in,
                      _frame_tensors(lidar_to_cam, frame, self.rng_used))
            given = _state_tensors(state)
            if len(given) != len(self.returned) or any(
                    a is not b for a, b in zip(given, self.returned)):
                copy_into(self.state_in, given)
            self.replay_a()
            nbs = depth_pair_gather(self.cfg, self.camera, state.frame_last,
                                    self.frame.uv_prev, self.front[2],
                                    self.frame.uv_new)
            copy_into(leaves(self.nbs), leaves(nbs))
            self.replay_b()
            out = clone_tree(self.out)
            self.returned = tuple(_state_tensors(out[0]))
        return out

    def _warm_up_and_capture(self, lidar_to_cam, state, frame):
        cfg, camera = self.cfg, self.camera
        kept = []

        def depth_pair(cfg, camera, lidar_to_cam, frame_a, uv_a, valid_a,
                       gp_a, frame_b, uv_b, valid_b, gp_b):
            nbs = depth_pair_gather(cfg, camera, frame_a, uv_a, frame_b, uv_b)
            kept.append(nbs)
            return depth_pair_cascade(cfg, camera, lidar_to_cam, nbs, uv_a,
                                      valid_a, gp_a, uv_b, valid_b, gp_b)

        out = self.graphs.eager(cfg, camera, lidar_to_cam, state, frame,
                                depth_pair)
        self.nbs = kept[0]
        self.frame_in = [t.clone() for t in
                         _frame_tensors(lidar_to_cam, frame, self.rng_used)]
        self.state_in = [t.clone() for t in _state_tensors(state)]
        rot, trans, cloud, cloud_valid, ids, ids_valid, uv_new, uv_prev, \
            stamp, *rest = self.frame_in
        semantic = rest.pop(0) if frame.semantic is not None else None
        l2c = lidar_to_cam._replace(rotation=rot, translation=trans)
        self.frame = frame._replace(
            cloud=cloud, cloud_valid=cloud_valid, ids=ids,
            ids_valid=ids_valid, uv_new=uv_new, uv_prev=uv_prev, stamp=stamp,
            rng=tuple(rest) if self.rng_used else None, semantic=semantic)
        *table, coeffs, ok, counters = self.state_in
        s_state = state._replace(
            table=state.table._make(table), frame_last=None,
            gp_last=state.gp_last._replace(coeffs=coeffs, inlier_mask=None,
                                           ok=ok),
            counters=counters)

        def graph_b():
            gp, (_, is_new), _ = self.front
            est_prev, est_new = depth_pair_cascade(
                cfg, camera, l2c, self.nbs, self.frame.uv_prev, is_new,
                s_state.gp_last, self.frame.uv_new, self.frame.ids_valid, gp)
            result = self.graphs.back(s_state, self.frame, self.front,
                                      est_prev, est_new)
            copy_into(self.state_in, _state_tensors(result[0]))
            return result

        capture = self.graphs.capture
        replay_a, self.front, pool = capture(
            lambda: self.graphs.front(cfg, camera, l2c, s_state.table,
                                      self.frame))
        self.replay_b, self.out, _ = capture(graph_b, pool)
        self.replay_a = replay_a
        return out


class FrameGraphs:
    """The `FrameGraph` of each input signature, the `bound` most recently
    used kept.  `eager`, `front` and `back` are tracks/pipeline.py's eager
    body and its stages before and after the depth pair; `capture`
    records a body (`capture_cuda`) on devices of `device_type`."""

    def __init__(self, eager: Callable, front: Callable, back: Callable,
                 capture: Callable = capture_cuda, device_type: str = "cuda",
                 bound: int = BOUND):
        self.eager, self.front, self.back = eager, front, back
        self.capture, self.device_type, self.bound = (capture, device_type,
                                                      bound)
        self.graphs: OrderedDict = OrderedDict()

    def signature(self, cfg, camera, lidar_to_cam, state, frame):
        """The key of the frame's graphs, or None where it runs eagerly
        (`process_frame`'s docstring says when)."""
        if cfg.do_use_depth_segmentation or cfg.set_all_depths_to_zero:
            return None
        generator = isinstance(frame.rng, torch.Generator)
        rng_used = cfg.do_use_ransac_plane and frame.semantic is None
        if rng_used and generator:
            return None
        tensors = (_frame_tensors(lidar_to_cam, frame, rng_used)
                   + leaves(state))
        dev = tensors[0].device
        if dev.type != self.device_type or any(t.device != dev
                                               for t in tensors):
            return None
        if dev.type == "cuda" and (
                dev.index != torch.cuda.current_device()
                or torch.cuda.is_current_stream_capturing()):
            return None
        return (dev, cfg, camera, frame.semantic is not None, generator,
                rng_used, tuple((t.shape, t.dtype) for t in tensors),
                _kernel_switches())

    def get(self, cfg, camera, lidar_to_cam, state, frame
            ) -> Optional[FrameGraph]:
        """The frame's `FrameGraph` (a new one on a new signature), or None
        where it runs eagerly."""
        key = self.signature(cfg, camera, lidar_to_cam, state, frame)
        if key is None:
            return None
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = FrameGraph(self, cfg, camera, key[5])
            while len(self.graphs) > self.bound:
                self.graphs.popitem(last=False)
        else:
            self.graphs.move_to_end(key)
        return graph
