"""The depth cascade's routing and its kernel wrapper on the CPU
(core/depth_estimator._depth_cascade, core/depth_cascade.py).

CPU tensors and region growing take the plain body
(`_depth_cascade_plain`), whose output the routed call returns unchanged;
CUDA tensors without region growing take `depth_cascade.cascade_cuda`.
The wrapper refuses CPU tensors, region growing, and tensors of another
dtype, shape, layout or device than the kernel takes; its parameter
structure and its result codes mirror the CUDA source.  The kernel itself
is held to the plain body on the card by
tests/test_torch_depth_cascade_card.py.
"""

import ctypes
import dataclasses
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import mono_lidar_depth_tpu_torch as T
from mono_lidar_depth_tpu_torch import kernels
from mono_lidar_depth_tpu_torch.core import depth_cascade
from mono_lidar_depth_tpu_torch.core import depth_estimator as de
from mono_lidar_depth_tpu_torch.core.neighbors import NeighborSet
from mono_lidar_depth_tpu_torch.core.result_types import DepthResultType
from mono_lidar_depth_tpu_torch.obs.launches import kernel_launches

SOURCE = (Path(T.__file__).resolve().parent / "csrc" / "depth_cascade.cu")
CAM = T.PinholeCamera(width=1226, height=370, focal_length=707.0912,
                      cx=601.8873, cy=183.1104)
N, K1, K2 = 64, 88, 210


def _window(rng, K, flags: bool):
    mask = rng.random((N, K)) < rng.choice([0.0, 0.1, 0.5, 1.0], (N, 1))
    pts = np.stack([rng.normal(size=(N, K)), rng.normal(size=(N, K)) + 1.5,
                    rng.uniform(2.0, 40.0, (N, 1))
                    + 0.05 * rng.normal(size=(N, K))], -1)
    pts = np.where(mask[..., None], pts, 0.0).astype(np.float32)
    fl = mask & (rng.random((N, K)) < 0.7) if flags else None
    t = torch.from_numpy
    return NeighborSet(indices=None, mask=t(mask), points_cam=t(pts),
                       count=t(mask.sum(-1).astype(np.int32)),
                       z=t(np.ascontiguousarray(pts[..., 2])),
                       flags=None if fl is None else t(fl))


def _args(seed: int = 0):
    """(nb1, nb2, uv, valid, coeffs [N, 4], gp_ok [N]) on the CPU."""
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(0, 1226, N), rng.uniform(0, 370, N)], -1)
    coeffs = np.tile(np.float32([0.0, -1.0, 0.0, 1.5]), (N, 1))
    return (_window(rng, K1, False), _window(rng, K2, True),
            torch.from_numpy(uv.astype(np.float32)),
            torch.from_numpy(rng.random(N) < 0.9), torch.from_numpy(coeffs),
            torch.from_numpy(rng.random(N) < 0.7))


@pytest.mark.parametrize("switches", [
    {}, dict(collect_debug=True), dict(do_use_ransac_plane=False),
    dict(do_use_PCA=True)])
def test_cpu_tensors_take_the_plain_body(monkeypatch, switches):
    """The routed call on CPU tensors is the plain body's result, bit for
    bit, and never reaches the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("cascade_cuda on CPU tensors")

    monkeypatch.setattr(de, "cascade_cuda", refuse)
    cfg = T.DepthEstimatorConfig(**switches)
    nb1, nb2, uv, valid, coeffs, ok = _args(1)
    nb2 = nb2 if cfg.do_use_ransac_plane else None
    got = de._depth_cascade(cfg, CAM, nb1, nb2, uv, valid, coeffs, ok)
    want = de._depth_cascade_plain(cfg, CAM, nb1, nb2, uv, valid, coeffs, ok)
    for x, y in zip(T.graphs.leaves(got), T.graphs.leaves(want)):
        assert torch.equal(x, y)
    assert len(T.graphs.leaves(got)) == (10 if cfg.collect_debug else 3)
    codes = set(got.codes.tolist())
    assert len(codes) >= 3, codes


def test_routing_by_device_and_configuration(monkeypatch):
    """CUDA tensors go to the kernel's wrapper, unless region growing is on:
    that configuration keeps the plain body on every device."""
    calls = []
    monkeypatch.setattr(de, "_depth_cascade_plain",
                        lambda *a: calls.append("plain") or "plain")
    monkeypatch.setattr(
        de, "cascade_cuda",
        lambda *a: calls.append("kernel") or (a[4], a[4], None))
    monkeypatch.setattr(de, "count_codes", lambda codes, valid: None)
    on_card = types.SimpleNamespace(
        device=torch.device("cuda"), to=lambda dtype: on_card,
        contiguous=lambda: on_card)
    nb1 = types.SimpleNamespace(count=None)
    for growing, uv, want in ((False, on_card, "kernel"),
                              (True, on_card, "plain"),
                              (False, torch.zeros(3, 2), "plain"),
                              (True, torch.zeros(3, 2), "plain")):
        cfg = T.DepthEstimatorConfig(do_use_depth_segmentation=growing)
        calls.clear()
        de._depth_cascade(cfg, CAM, nb1, None, uv, None, None, None)
        assert calls == [want], (growing, uv)


def test_wrapper_refuses_cpu_tensors_and_region_growing():
    nb1, nb2, uv, valid, coeffs, ok = _args()
    cfg = T.DepthEstimatorConfig()
    with pytest.raises(ValueError, match="CUDA"):
        depth_cascade.cascade_cuda(cfg, CAM, nb1, nb2, uv, valid, coeffs, ok)
    with pytest.raises(ValueError, match="region growing"):
        depth_cascade.cascade_cuda(
            dataclasses.replace(cfg, do_use_depth_segmentation=True), CAM,
            nb1, nb2, uv, valid, coeffs, ok)


BAD = {
    "uv float64": lambda a: a.update(uv=a["uv"].double()),
    "uv [N, 3]": lambda a: a.update(uv=torch.zeros(N, 3)),
    "valid uint8": lambda a: a.update(valid=a["valid"].to(torch.uint8)),
    "valid short": lambda a: a.update(valid=a["valid"][:-1]),
    "mask shape": lambda a: a.update(nb1=a["nb1"]._replace(
        mask=a["nb1"].mask[:, :-1])),
    "points strided": lambda a: a.update(nb1=a["nb1"]._replace(
        points_cam=a["nb1"].points_cam.transpose(0, 1).contiguous()
        .transpose(0, 1))),
    "count int64": lambda a: a.update(nb1=a["nb1"]._replace(
        count=a["nb1"].count.long())),
    "z float64": lambda a: a.update(nb2=a["nb2"]._replace(
        z=a["nb2"].z.double())),
    "road window missing": lambda a: a.update(nb2=None),
    "flags missing": lambda a: a.update(nb2=a["nb2"]._replace(flags=None)),
    "coeffs [3]": lambda a: a.update(coeffs=torch.zeros(3)),
    "coeffs [N, 4] float64": lambda a: a.update(coeffs=a["coeffs"].double()),
    "gp_ok [N, 1]": lambda a: a.update(ok=a["ok"][:, None]),
    "points on another device": lambda a: a.update(nb1=a["nb1"]._replace(
        points_cam=a["nb1"].points_cam.to("meta"))),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_refuses_malformed_tensors(bad):
    args = dict(zip(("nb1", "nb2", "uv", "valid", "coeffs", "ok"), _args()))
    cfg = T.DepthEstimatorConfig()

    def check():
        return depth_cascade.check_args(
            cfg, args["nb1"], args["nb2"], args["uv"], args["valid"],
            args["coeffs"], args["ok"])

    assert check() == (N, K1, K2)
    BAD[bad](args)
    with pytest.raises(ValueError):
        check()


def test_wrapper_takes_every_plane_form():
    """A plane per lane or one for all, gp_ok per lane or 0-dim; no road
    window and k2 = 0 with the road pass off."""
    nb1, nb2, uv, valid, coeffs, ok = _args()
    cfg = T.DepthEstimatorConfig()
    assert depth_cascade.check_args(cfg, nb1, nb2, uv, valid, coeffs[0],
                                    ok[0]) == (N, K1, K2)
    off = dataclasses.replace(cfg, do_use_ransac_plane=False)
    assert depth_cascade.check_args(off, nb1, None, uv, valid, coeffs,
                                    ok) == (N, K1, 0)


def _c_fields(struct: str):
    text = SOURCE.read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\}};", text, re.S).group(1)
    body = re.sub(r"//.*", "", body)
    fields = []
    for ctype, names in re.findall(r"(\w+)\s+([\w, ]+);", body):
        fields += [(n.strip(), ctype) for n in names.split(",")]
    return fields


def test_params_structure_matches_the_source():
    """kernels.CascadeParams mirrors `struct MldCascadeParams` field for
    field: names, order, sizes."""
    size = {"float": 4, "int32_t": 4}
    py = [(n, ctypes.sizeof(t)) for n, t in kernels.CascadeParams._fields_]
    assert py == [(n, size[t]) for n, t in _c_fields("MldCascadeParams")]
    assert len(py) == 33


def test_result_codes_match_the_source():
    """The source's constants are DepthResultType's values."""
    text = SOURCE.read_text()
    found = dict(re.findall(r"constexpr int k(\w+) = (\d+);", text))
    codes = {name: int(v) for name, v in found.items()
             if name in DepthResultType.__members__}
    assert len(codes) == 17
    for name, value in codes.items():
        assert DepthResultType[name] == value, name


@pytest.mark.parametrize("road,mode", [
    (dict(), 0),
    (dict(plane_estimator_use_mestimator=False,
          plane_estimator_use_leastsquares=True), 1),
    (dict(plane_estimator_use_mestimator=False,
          plane_estimator_use_triangle_maximation=True), 2)])
def test_params_carry_the_configuration(road, mode):
    """Switches as 0 / 1, thresholds as the float32 values PyTorch compares
    with, the road estimator by its number."""
    cfg = T.DepthEstimatorConfig(
        **road, viewray_plane_orthoganality_treshold=0.0)
    p = depth_cascade.cascade_params(cfg, CAM, K1, K2)
    assert (p.k1, p.k2, p.road_estimator) == (K1, K2, mode)
    assert (p.use_histogram, p.use_pca, p.check_ortho, p.collect_debug) == (
        1, 0, 0, 0)
    assert p.num_bins == cfg.histogram_bins
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    assert p.bin_width == f32(cfg.histogram_segmentation_bin_witdh)
    assert p.far_threshold == f32(cfg.ransac_plane_point_distance_treshold)
    assert p.pca_21_rel_min == T.core.geometry.f32(
        cfg.pca_treshold_2_1_rel_min)
    assert (p.cx, p.focal) == (f32(CAM.cx), f32(CAM.focal_length))


def test_kernel_launches_counts_the_cascade():
    assert "depth_cascade" in kernel_launches()
    assert kernel_launches()["depth_cascade"] == depth_cascade.launches
