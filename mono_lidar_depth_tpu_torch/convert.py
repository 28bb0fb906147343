"""Carry state between the JAX package and the port.

There are no learned weights; what crosses over is state: FrameCloud,
GroundPlane, TrackTable, TrackletDepthState, OdometryState, TrackerState
(and SE3 / BAProblem / FrameInput / TrackerOutput).  The port's NamedTuples keep the JAX field
names and layouts, so a tree converts field by field:

  * `state_from_numpy(tree, device)`: a tree of numpy arrays — a
    NamedTuple of the JAX package (e.g. after
    `jax.tree.map(np.asarray, state)`), a dict, list or tuple — becomes
    the port's tree on `device`; a NamedTuple maps to the port's class
    of the same name.
  * `state_to_numpy(tree)`: the inverse, port tree -> numpy leaves in
    the same (port) structure.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.depth_estimator import DepthEstimate
from .core.geometry import SE3
from .core.projection import FrameCloud
from .core.ransac import GroundPlane
from .device import Device, default_device
from .tracker.frontend import TrackerOutput, TrackerState
from .tracks.pipeline import FrameInput, TrackletDepthState
from .tracks.table import TrackTable
from .vo.ba import BAProblem
from .vo.pipeline import OdometryState

_PORT_TYPES = {cls.__name__: cls for cls in (
    SE3, FrameCloud, GroundPlane, TrackTable, TrackletDepthState,
    FrameInput, OdometryState, BAProblem, DepthEstimate, TrackerState,
    TrackerOutput)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def state_from_numpy(tree, device: Device = default_device()):
    """Numpy tree -> the port's tree of tensors on `device`."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.tensor(np.asarray(tree)).to(device)
    if _is_namedtuple(tree):
        name = type(tree).__name__
        cls = _PORT_TYPES.get(name)
        if cls is None:
            raise TypeError(f"no port type named {name}")
        if cls._fields != tree._fields:
            raise TypeError(f"{name}: fields {tree._fields} do not match the "
                            f"port's {cls._fields}")
        return cls(*(state_from_numpy(x, device) for x in tree))
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_numpy(x, device) for x in tree)
    raise TypeError(f"cannot convert {type(tree).__name__}")


def state_to_numpy(tree):
    """The port's tree -> the same structure with numpy leaves."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if _is_namedtuple(tree):
        return type(tree)(*(state_to_numpy(x) for x in tree))
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_to_numpy(x) for x in tree)
    raise TypeError(f"cannot convert {type(tree).__name__}")
