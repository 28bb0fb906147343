"""Checkpoint / resume for pipeline state (counterpart of
io/checkpoint.py).

Format: a single .npz (written to a temporary file and renamed, so a
reader never sees a partial file) holding the flattened leaves
`leaf_<i>`, their key paths, the root's type name and the metadata.
Leaves are restored by PATH, not by position, so a state field inserted in
the middle of a NamedTuple cannot shift later leaves onto values that
happen to have a compatible shape.

The state is a nest of NamedTuples, tuples, lists, dicts and None with
tensor (or numpy, or scalar) leaves.  The nest is flattened here, in the
order and with the path strings of `jax.tree_util`: `.field` for a
NamedTuple field, `[i]` for a tuple or list index, `['k']` for a dict key
(keys sorted), nothing for None.  A file written by the JAX package
therefore loads into the port's state of the same layout, and the other
way round.  Files without key paths (an older format of the JAX package)
load by position.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch


def _children(node) -> list[tuple[str, Any]] | None:
    """(path step, child) of a container node, None for a leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{name}", getattr(node, name)) for name in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    return None


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) of every leaf, depth first; None holds no leaf."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(path, tree)]
    out = []
    for step, child in children:
        out += _flatten(child, path + step)
    return out


def _unflatten(like, leaves: list):
    """`like`'s structure filled with `leaves` in `_flatten`'s order
    (consumes the list from the front)."""
    if like is None:
        return None
    children = _children(like)
    if children is None:
        return leaves.pop(0)
    new = [_unflatten(child, leaves) for _, child in children]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*new)
    if isinstance(like, dict):
        return dict(zip(sorted(like), new))
    return type(like)(new)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, state: Any, metadata: dict | None = None
                    ) -> None:
    """Snapshot a state tree to `path` (atomically)."""
    kp_leaves = _flatten(state)
    arrays = {f"leaf_{i}": _to_numpy(leaf)
              for i, (_, leaf) in enumerate(kp_leaves)}
    arrays["__keypaths__"] = np.frombuffer(
        json.dumps([p for p, _ in kp_leaves]).encode(), dtype=np.uint8)
    # informational, as in the JAX package's files; load ignores it
    arrays["__treedef__"] = np.frombuffer(
        type(state).__name__.encode(), dtype=np.uint8)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, like: Any,
                    allow_missing_trailing: bool = False) -> tuple[Any, dict]:
    """Restore a tree saved by `save_checkpoint` (this one or the JAX
    package's).

    `like` provides the structure (e.g. a freshly created state of the
    same sizes); leaf VALUES come from the file.  Shapes are checked leaf
    by leaf; each leaf takes the dtype of `like`'s and, where that is a
    tensor, its device.  Leaves are matched by key path: a field that
    `like` has and the file lacks is an error, unless
    `allow_missing_trailing` lets it default from `like`; stored leaves
    of fields that `like` no longer has are ignored.

    Returns (state, metadata).
    """
    z = np.load(path)
    kp_like = _flatten(like)
    n = len(kp_like)

    def check(ref, arr: np.ndarray, label: str):
        if arr.shape != tuple(np.shape(ref)):
            raise ValueError(f"leaf {label}: shape {arr.shape} != expected "
                             f"{tuple(np.shape(ref))}")
        if isinstance(ref, torch.Tensor):
            return torch.tensor(arr).to(device=ref.device, dtype=ref.dtype)
        return arr.astype(np.asarray(ref).dtype)

    meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}

    leaves = []
    if "__keypaths__" in z:
        stored_paths = json.loads(bytes(z["__keypaths__"]).decode())
        by_path = {p: i for i, p in enumerate(stored_paths)}
        for p, leaf in kp_like:
            if p in by_path:
                leaves.append(check(leaf, z[f"leaf_{by_path[p]}"], p))
            elif allow_missing_trailing:
                leaves.append(leaf)
            else:
                raise ValueError(
                    f"checkpoint is missing leaf {p!r} "
                    f"(stored: {len(stored_paths)} leaves, expected {n}; "
                    "pass allow_missing_trailing=True to default new "
                    "fields from `like`)")
        return _unflatten(like, leaves), meta

    # files without key paths: positional, trailing leaves may default
    for i, (_, leaf) in enumerate(kp_like):
        key = f"leaf_{i}"
        if key not in z:
            if allow_missing_trailing:
                leaves.extend(l for _, l in kp_like[i:])
                break
            raise ValueError(
                f"checkpoint has "
                f"{len([k for k in z.files if k.startswith('leaf_')])} "
                f"leaves, expected {n}")
        leaves.append(check(leaf, z[key], str(i)))
    return _unflatten(like, leaves), meta
