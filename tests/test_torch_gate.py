"""The tracker's acceptance gate (tracker/klt.py::_track_gate) against the
JAX package's composition of the same tests at the end of
`track_features`, on the CPU: the same numpy images, positions and flags
go through both.

Tolerances.  The blends and the 81-term sums run in other orders in XLA
(which also contracts a*b+c into FMAs) and in PyTorch, so `ncc` agrees to
NCC_TOL, not to the bit; `ok` is held equal on every lane whose `ncc` and
forward-backward error are farther than NCC_TOL from their thresholds,
where a rounding difference cannot flip the comparison.  A lane both of
whose patches are flat (all taps on one clamped corner pixel) has a zero
denominator up to rounding, which `_zncc` floors at 1e-8: its `ncc` is
rounding noise over that floor, held under FLAT_NCC in both and not
compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mono_lidar_depth_tpu.tracker import klt as jklt
from mono_lidar_depth_tpu_torch.core import windows as twindows
from mono_lidar_depth_tpu_torch.tracker import klt as tklt

from torch_parity import OnCard as _OnCard

NCC_TOL = 1e-6
FLAT_DEN, FLAT_NCC = 1e-6, 1e-3  # observed on flat lanes: |ncc| <= 2.4e-4
MIN_NCC, FB_THRESHOLD = 0.6, 1.0
NAN, INF = float("nan"), float("inf")


def texture(seed, h, w):
    """Blocks of random grey with fine noise, lightly blurred: in
    [0, 1.3], with structure in every patch."""
    rng = np.random.default_rng(seed)
    img = np.kron(rng.random(((h + 7) // 8, (w + 7) // 8)),
                  np.ones((8, 8)))[:h, :w]
    img = img + 0.3 * rng.random((h, w))
    k = np.array([1, 4, 6, 4, 1]) / 16.0
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return np.ascontiguousarray(img.astype(np.float32))


def gate_case(seed, h, w, n):
    """Two frames (the second the first moved by about (1.3, 0.8) px),
    start positions, forward and backward results and the three flags.
    The first lanes are the special ones: on and past every border, on
    and beside the in-image limits, on and beside the forward-backward
    threshold, NaN and infinite coordinates in each of the three
    position arrays."""
    rng = np.random.default_rng(seed)
    img0 = texture(seed, h, w)
    img1 = np.roll(np.roll(img0, 1, 1), 1, 0) * 0.7 + img0 * 0.3
    uv = rng.uniform([3, 3], [w - 4, h - 4], (n, 2))
    uv_f = uv + [1.3, 0.8] + rng.normal(0, 0.3, (n, 2))
    # backward error: mostly small, a quarter around and past the threshold
    uv_b = uv + rng.normal(0, 0.2, (n, 2))
    far = rng.random(n) < 0.25
    uv_b[far] += rng.normal(0, 1.0, (int(far.sum()), 2))
    below = float(np.nextafter(np.float32(1), np.float32(0)))
    above = float(np.nextafter(np.float32(1), np.float32(2)))
    special = [
        # (uv, uv_f, uv_b): borders
        ((-7.5, 30), (-6.0, 31), (-7.4, 30)),
        ((0.0, 0.0), (0.5, 0.5), (0.0, 0.0)),
        ((w - 1.0, h - 1.0), (w - 1.2, h - 1.3), (w - 1.0, h - 1.0)),
        ((w + 6.0, 20.0), (w + 7.0, 20.0), (w + 6.0, 20.0)),
        ((40.5, -6.2), (41.0, -5.0), (40.5, -6.1)),
        ((30.7, h + 5.5), (31.0, h + 6.0), (30.7, h + 5.5)),
        # in-image limits of uv_f: on them, and one float inside
        ((10, 10), (1.0, 10.5), (10, 10)),
        ((10, 10), (above, 10.5), (10, 10)),
        ((10, 10), (w - 2.0, 10.5), (10, 10)),
        ((10, 10), (float(np.nextafter(np.float32(w - 2), np.float32(0))),
                    10.5), (10, 10)),
        ((10, 10), (10.5, 1.0), (10, 10)),
        ((10, 10), (10.5, h - 2.0), (10, 10)),
        ((10, 10), (10.5, float(np.nextafter(np.float32(h - 2),
                                             np.float32(0)))), (10, 10)),
        # forward-backward error exactly on, just under, just over 1 px
        ((12, 12), (13, 13), (13.0, 12.0)),
        ((12, 12), (13, 13), (12.0, 12 + below)),
        ((12, 12), (13, 13), (12.0, 12 + above)),
        ((12, 12), (13, 13), (12.6, 12.8)),  # 0.36 + 0.64
        # NaN and infinite coordinates
        ((NAN, 12), (13, 13), (12, 12)), ((12, NAN), (13, 13), (12, 12)),
        ((12, 12), (NAN, 13), (12, 12)), ((12, 12), (13, NAN), (12, 12)),
        ((12, 12), (13, 13), (NAN, 12)), ((12, 12), (13, 13), (12, NAN)),
        ((NAN, NAN), (NAN, NAN), (NAN, NAN)),
        ((INF, 12), (13, 13), (12, 12)), ((12, -INF), (13, 13), (12, 12)),
        ((12, 12), (INF, 13), (12, 12)), ((12, 12), (13, -INF), (12, 12)),
        ((12, 12), (13, 13), (INF, 12)), ((12, 12), (13, 13), (12, -INF)),
        ((INF, INF), (INF, INF), (INF, INF)),
    ]
    assert len(special) < n
    for i, (a, b, c) in enumerate(special):
        uv[i], uv_f[i], uv_b[i] = a, b, c
    flags = [rng.random(n) < 0.9 for _ in range(3)]
    for f in flags:
        f[:len(special)] = True  # the special lanes pass or fail on merit
    return (img0, img1, uv.astype(np.float32), uv_f.astype(np.float32),
            uv_b.astype(np.float32), *flags), len(special)


def jax_gate(img0, img1, uv, uv_f, uv_b, valid, ok_f, ok_b, patch):
    """mono_lidar_depth_tpu/tracker/klt.py::track_features from the
    forward-backward error to `ok`, on given LK results."""
    img0, img1, uv, uv_f, uv_b, valid, ok_f, ok_b = map(
        jnp.asarray, (img0, img1, uv, uv_f, uv_b, valid, ok_f, ok_b))
    fb_err = jnp.linalg.norm(uv_b - uv, axis=1)
    H, W = img1.shape
    in_img = ((uv_f[:, 0] > 1) & (uv_f[:, 0] < W - 2)
              & (uv_f[:, 1] > 1) & (uv_f[:, 1] < H - 2))
    t = jklt._bilinear_patches(img0, uv, patch)
    c = jklt._bilinear_patches(img1, uv_f, patch)
    ncc = jklt._zncc(t, c)
    ok = (valid & ok_f & ok_b & (fb_err < FB_THRESHOLD) & in_img
          & (ncc > MIN_NCC))
    den = jnp.sqrt(jnp.sum((t - t.mean(1, keepdims=True)) ** 2, axis=1)
                   * jnp.sum((c - c.mean(1, keepdims=True)) ** 2, axis=1))
    return tuple(map(np.asarray, (ok, ncc, fb_err, den)))


def t(x):
    return torch.from_numpy(np.array(x))  # a writable, contiguous copy


@pytest.mark.parametrize("hw,n", [((64, 96), 256), ((37, 123), 64)])
@pytest.mark.parametrize("patch", [5, 9, 15])
def test_track_gate_reference_matches_jax(hw, n, patch):
    case, n_special = gate_case(patch + n, *hw, n)
    jok, jncc, jfb, jden = jax_gate(*case, patch)
    ok, ncc = tklt._track_gate_reference(*map(t, case), patch, MIN_NCC,
                                         FB_THRESHOLD)
    assert ok.dtype == torch.bool and ncc.dtype == torch.float32
    assert tuple(ok.shape) == tuple(ncc.shape) == (n,)
    ok, ncc = ok.numpy(), ncc.numpy()
    # NaN exactly where JAX has it: a NaN coordinate in uv or uv_f
    nan_lane = np.isnan(case[2]).any(1) | np.isnan(case[3]).any(1)
    np.testing.assert_array_equal(np.isnan(jncc), nan_lane)
    np.testing.assert_array_equal(np.isnan(ncc), nan_lane)
    flat = jden < FLAT_DEN  # NaN compares False
    assert 1 <= flat.sum() <= 3  # the lanes at (inf, inf), (w + 6, 20)
    assert np.abs(ncc[flat]).max() <= FLAT_NCC
    assert np.abs(jncc[flat]).max() <= FLAT_NCC
    held = ~nan_lane & ~flat
    # observed max difference 3.6e-7
    np.testing.assert_allclose(ncc[held], jncc[held], atol=NCC_TOL, rtol=0)
    decided = ~((np.abs(jncc - MIN_NCC) <= NCC_TOL)
                | (np.abs(jfb - FB_THRESHOLD) <= NCC_TOL))
    np.testing.assert_array_equal(ok[decided], jok[decided])
    assert (~decided).sum() <= 6  # the lanes put on the thresholds
    # non-finite coordinates never pass, in either
    bad = ~(np.isfinite(case[2]).all(1) & np.isfinite(case[3]).all(1)
            & np.isfinite(case[4]).all(1))
    assert bad.sum() == 14 and not ok[bad].any() and not jok[bad].any()
    # the gate decides: it passes and fails lanes among the ordinary ones
    assert 0.2 < ok[n_special:].mean() < 0.9


def test_track_gate_each_test_can_fail_alone():
    """Every one of the six conjuncts rejects lanes that the others
    accept."""
    case, n_special = gate_case(3, 64, 96, 256)
    img0, img1, uv, uv_f, uv_b, valid, ok_f, ok_b = map(t, case)
    everything = torch.ones_like(valid)
    base, ncc = tklt._track_gate_reference(
        img0, img1, uv, uv_f, uv_b, everything, everything, everything, 9,
        -2.0, 1e9)
    in_img = ((uv_f[:, 0] > 1) & (uv_f[:, 0] < 94) & (uv_f[:, 1] > 1)
              & (uv_f[:, 1] < 62))
    d = uv_b - uv
    fb = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    assert torch.equal(base, in_img & ~torch.isnan(ncc) & (fb < 1e9))
    for k in range(3):
        flags = [everything] * 3
        flags[k] = (valid, ok_f, ok_b)[k]
        ok, _ = tklt._track_gate_reference(img0, img1, uv, uv_f, uv_b,
                                           *flags, 9, -2.0, 1e9)
        assert torch.equal(ok, base & flags[k]) and not torch.equal(ok, base)
    ok, _ = tklt._track_gate_reference(img0, img1, uv, uv_f, uv_b,
                                       everything, everything, everything, 9,
                                       MIN_NCC, 1e9)
    assert torch.equal(ok, base & (ncc > MIN_NCC)) and 0 < ok.sum() < base.sum()
    ok, _ = tklt._track_gate_reference(img0, img1, uv, uv_f, uv_b,
                                       everything, everything, everything, 9,
                                       -2.0, FB_THRESHOLD)
    assert torch.equal(ok, base & (fb < FB_THRESHOLD))
    assert 0 < ok.sum() < base.sum()


def test_track_gate_takes_the_plain_version_on_the_cpu():
    case, _ = gate_case(5, 37, 123, 64)
    before = (tklt.gate_launches, tklt.launches, twindows.launches)
    a = tklt._track_gate(*map(t, case), 9, MIN_NCC, FB_THRESHOLD)
    b = tklt._track_gate_reference(*map(t, case), 9, MIN_NCC, FB_THRESHOLD)
    assert torch.equal(a[0], b[0])
    assert torch.equal(torch.nan_to_num(a[1], nan=7.0),
                       torch.nan_to_num(b[1], nan=7.0))
    assert (tklt.gate_launches, tklt.launches, twindows.launches) == before


def test_track_features_ends_in_the_gate(monkeypatch):
    """`track_features` hands the gate its two finest images, the start
    positions, both passes' results and flags (`_track_passes`), and
    returns the gate's `ok` with the forward positions."""
    case, _ = gate_case(7, 64, 96, 256)
    img0, img1, uv, _, _, valid, _, _ = map(t, case)
    pyr0, pyr1 = tklt.build_pyramid(img0, 2), tklt.build_pyramid(img1, 2)
    seen = {}

    def spy(*args):
        seen["args"] = args
        return tklt._track_gate_reference(*args)

    monkeypatch.setattr(tklt, "_track_gate", spy)
    uv_f, ok = tklt.track_features(pyr0, pyr1, uv, valid, patch=7,
                                   min_ncc=0.5, fb_threshold=0.8)
    a = seen["args"]
    assert a[0] is pyr0[0] and a[1] is pyr1[0] and a[2] is uv
    assert a[3] is uv_f and a[5] is valid and a[8:] == (7, 0.5, 0.8)
    want, _ = tklt._track_gate_reference(*a)
    assert torch.equal(ok, want)
    fwd, ok_f, back, ok_b = tklt._track_passes_reference(pyr0, pyr1, uv, None,
                                                         7, 8, 1e-4)
    assert torch.equal(uv_f.nan_to_num(7.0), fwd.nan_to_num(7.0))
    assert torch.equal(a[4].nan_to_num(7.0), back.nan_to_num(7.0))
    assert torch.equal(a[6], ok_f) and torch.equal(a[7], ok_b)


def _cuda_args():
    case, _ = gate_case(9, 37, 123, 64)
    return list(map(t, case))


def test_track_gate_cuda_refuses_cpu_tensors():
    """The CUDA-only entry raises on CPU tensors rather than fall back."""
    with pytest.raises(ValueError, match="CUDA"):
        tklt._track_gate_cuda(*_cuda_args(), 9, MIN_NCC, FB_THRESHOLD)
    assert tklt.gate_launches == 0


@pytest.mark.parametrize("what,match", [
    ("even patch", "patch must be odd"),
    ("patch 17", "patch must be odd and at most 15"),
    ("image shapes", "one shape"),
    ("f64 image", "prev_img must be torch.float32"),
    ("f64 uv_f", "uv_f must be torch.float32"),
    ("int flags", "ok_b must be torch.bool"),
    ("uv shape", r"uv_b must be \[64, 2\]"),
    ("flag shape", r"valid must be \[64\]"),
    ("strided uv", "uv must be contiguous"),
    ("strided image", "next_img must be contiguous"),
    ("other device", "ok_f must be torch.bool on cuda:0"),
])
def test_track_gate_cuda_argument_checks(what, match):
    """Every refusal of the wrapper, reached with stand-ins for tensors on
    a card: even or too large a patch, wrong dtype, shape, stride,
    device."""
    names = ["prev_img", "next_img", "uv", "uv_f", "uv_b", "valid", "ok_f",
             "ok_b"]
    args = dict(zip(names, _cuda_args()))
    fake = {k: _OnCard(v) for k, v in args.items()}
    patch = 9
    if what == "even patch":
        patch = 8
    elif what == "patch 17":
        patch = 17
    elif what == "image shapes":
        fake["next_img"] = _OnCard(args["next_img"], shape=(37, 124))
    elif what == "f64 image":
        fake["prev_img"] = _OnCard(args["prev_img"], dtype=torch.float64)
    elif what == "f64 uv_f":
        fake["uv_f"] = _OnCard(args["uv_f"], dtype=torch.float64)
    elif what == "int flags":
        fake["ok_b"] = _OnCard(args["ok_b"], dtype=torch.uint8)
    elif what == "uv shape":
        fake["uv_b"] = _OnCard(args["uv_b"], shape=(63, 2))
    elif what == "flag shape":
        fake["valid"] = _OnCard(args["valid"], shape=(64, 1))
    elif what == "strided uv":
        fake["uv"] = _OnCard(args["uv"], contiguous=False)
    elif what == "strided image":
        fake["next_img"] = _OnCard(args["next_img"], contiguous=False)
    elif what == "other device":
        fake["ok_f"].device = torch.device("cuda", 1)
    with pytest.raises(ValueError, match=match):
        tklt._track_gate_cuda(*[fake[k] for k in names], patch, MIN_NCC,
                              FB_THRESHOLD)
    assert tklt.gate_launches == 0
