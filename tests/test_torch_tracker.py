"""The port's tracker (tracker/harris.py, klt.py, frontend.py) against the
JAX package's on the CPU: the same numpy images and positions go through
both.  The JAX side runs as tests/test_tracker.py runs it (off-TPU
`slice_windows` takes `dynamic_slice`); the port's CPU path takes the
plain versions of both kernels.

Tolerances.  Pooling, convolutions and the 81-term patch sums run in
other orders in XLA and in PyTorch, and XLA contracts a*b+c into FMAs, so
float results agree to a few ulps of their scale, not to the bit.
Integer and boolean results (selection, ids, ages) are held bit-exact
where both sides are fed the same floats.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mono_lidar_depth_tpu.tracker import frontend as jfe
from mono_lidar_depth_tpu.tracker import harris as jharris
from mono_lidar_depth_tpu.tracker import klt as jklt
from mono_lidar_depth_tpu_torch.convert import state_to_numpy
from mono_lidar_depth_tpu_torch.core import windows as twindows
from mono_lidar_depth_tpu_torch.tracker import frontend as tfe
from mono_lidar_depth_tpu_torch.tracker import harris as tharris
from mono_lidar_depth_tpu_torch.tracker import klt as tklt

from torch_parity import OnCard, assert_trees_equal, to_numpy, to_port

H, W, LANES, LEVELS = 128, 192, 64, 3


def textured(seed, h=H, w=W):
    """Smooth random texture with corners everywhere, in [0, 1.3]."""
    rng = np.random.default_rng(seed)
    img = rng.random((h // 8, w // 8)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))
    img += 0.3 * rng.random((h, w)).astype(np.float32)
    # a light blur makes sub-pixel motion trackable
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16.0
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return np.ascontiguousarray(img.astype(np.float32))


def shifted(img, dx, dy):
    """The image moved by (dx, dy) px, fractions by bilinear blending of
    the two neighbouring integer shifts (wrapping at the edges)."""
    ix, iy = int(np.floor(dx)), int(np.floor(dy))
    fx, fy = np.float32(dx - ix), np.float32(dy - iy)

    def roll(sx, sy):
        return np.roll(np.roll(img, sy, 0), sx, 1)

    out = ((1 - fy) * ((1 - fx) * roll(ix, iy) + fx * roll(ix + 1, iy))
           + fy * ((1 - fx) * roll(ix, iy + 1) + fx * roll(ix + 1, iy + 1)))
    return np.ascontiguousarray(out.astype(np.float32))


def t(x):
    return torch.from_numpy(np.array(x))  # a writable, contiguous copy


@pytest.mark.parametrize("shape,levels", [((128, 192), 3), ((37, 123), 4),
                                          ((370, 306), 4)])
def test_build_pyramid(shape, levels):
    img = textured(1, *[(s + 7) // 8 * 8 for s in shape])[:shape[0], :shape[1]]
    jp = jklt.build_pyramid(jnp.asarray(img), levels)
    tp = tklt.build_pyramid(t(img), levels)
    assert len(jp) == len(tp) == levels
    for a, b in zip(jp, tp):
        assert tuple(a.shape) == tuple(b.shape)
        # a 4-term mean in another order: <= 1e-6 on values in [0, 1.3]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_sobel_and_response(seed):
    img = textured(seed)
    jx, jy = jharris.sobel_gradients(jnp.asarray(img))
    tx, ty = tharris.sobel_gradients(t(img))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=0)
    jr = np.asarray(jharris.shi_tomasi_response(jnp.asarray(img)))
    tr = tharris.shi_tomasi_response(t(img)).numpy()
    # 25-term box sums of products: <= 1e-5 of the response's maximum
    assert np.abs(tr - jr).max() <= 1e-5 * np.abs(jr).max()


def _jax_select(monkeypatch, resp, *args, **kwargs):
    """detect_features of the JAX package on a given response."""
    monkeypatch.setattr(jharris, "shi_tomasi_response",
                        lambda img, window=5: jnp.asarray(resp))
    return jharris.detect_features(jnp.zeros(resp.shape), *args, **kwargs)


@pytest.mark.parametrize("lanes,cell,occupied", [
    (64, 16, False), (64, 16, True),
    (128, 16, False),  # 96 cells < 128 lanes: the padded top-k branch
    (128, 16, True), (48, 8, True), (40, 24, False)])
def test_detect_features_selection_bit_exact(monkeypatch, lanes, cell,
                                             occupied):
    """The JAX response goes into both selections: uv, valid bit-exact
    (stable descending sort == lax.top_k's order among the -inf ties)."""
    img = textured(5)
    resp = np.asarray(jharris.shi_tomasi_response(jnp.asarray(img)))
    kw = dict(cell_size=cell)
    tkw = dict(kw)
    if occupied:
        rng = np.random.default_rng(7)
        occ = rng.uniform([-5, -5], [W + 5, H + 5], (lanes, 2)).astype(
            np.float32)
        occ_ok = rng.random(lanes) < 0.6
        kw.update(occupied_uv=jnp.asarray(occ),
                  occupied_valid=jnp.asarray(occ_ok))
        tkw.update(occupied_uv=t(occ), occupied_valid=t(occ_ok))
    juv, jok = _jax_select(monkeypatch, resp, lanes, **kw)
    tuv, tok = tharris.select_features(t(resp), lanes, **tkw)
    assert np.asarray(jok).sum() > 10
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    assert tuv.dtype == torch.float32 and tok.dtype == torch.bool


def test_detect_features_end_to_end():
    """On its own response the port picks the same corners wherever the
    responses are not within rounding of a tie."""
    img = textured(9)
    juv, jok = jharris.detect_features(jnp.asarray(img), LANES)
    tuv, tok = tharris.detect_features(t(img), LANES)
    same = (tuv.numpy() == np.asarray(juv)).all(1) & (
        tok.numpy() == np.asarray(jok))
    assert same.mean() >= 0.95  # observed 1.0


def _features(seed, n=LANES):
    rng = np.random.default_rng(seed)
    uv = rng.uniform([4, 4], [W - 5, H - 5], (n, 2)).astype(np.float32)
    # border cases: on, near and past every edge
    edge = np.array([[-7.5, 30], [-0.3, 50], [0.0, 0.0], [W - 1.0, H - 1.0],
                     [W - 0.4, 60.2], [W + 6.0, 64.0], [90.5, -6.2],
                     [77.7, H + 5.5], [W - 1.5, 0.3]], np.float32)
    uv[:len(edge)] = edge
    return uv


@pytest.mark.parametrize("patch", [5, 9])
def test_bilinear_patches(patch):
    img, uv = textured(2), _features(3)
    jp = jklt._bilinear_patches(jnp.asarray(img), jnp.asarray(uv), patch)
    tp = tklt._bilinear_patches(t(img), t(uv), patch)
    assert tuple(tp.shape) == (LANES, patch * patch)
    # three 2-term blends, contracted differently: <= 1e-6 on [0, 1.3]
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(128, 192), (16, 24), (370, 1226), (46, 153)])
@pytest.mark.parametrize("patch", [3, 9, 15])
def test_slack_clamp_never_reaches_the_crops_clamp(hw, patch):
    """With m = r + 2 + slack (and r + 1 + slack in _bilinear_patches)
    every crop start `_split_frac` can produce lies inside the padded
    image, so `slice_windows`' own clamp never moves a window."""
    h, w = hw
    r = (patch - 1) // 2
    slack = r + 1
    big = 1e6
    uv = t(np.array([[-big, -big], [big, big], [-slack, -slack],
                     [w - 1.001 + slack, h - 1.001 + slack],
                     [w + slack, h + slack], [np.nextafter(
                         np.float32(w + slack), np.float32(0)), 0.0]],
                    np.float32))
    ix, iy, fx, fy = tklt._split_frac(uv, h, w, slack)
    assert (fx >= 0).all() and (fx < 1).all()
    assert (fy >= 0).all() and (fy < 1).all()
    for m, lead, K in ((r + 2 + slack, r + 1, patch + 3),  # template
                       (r + 2 + slack, r, patch + 1),  # iterations
                       (r + 1 + slack, r, patch + 1)):  # ZNCC patches
        for i, size in ((ix, w), (iy, h)):
            start = i - lead + m
            assert int(start.min()) >= 0
            assert int(start.max()) <= size + 2 * m - K
    # the float32 bounds the kernel is handed are the clamp's own
    lo, hi_x, hi_y = tklt._clamp_bounds(h, w, slack)
    x = torch.clamp(uv[:, 0], -float(slack), w - 1.001 + slack)
    assert float(x.max()) == hi_x and float(x.min()) == lo


def _level_case(seed, dx=2.3, dy=1.6):
    img0 = textured(seed)
    img1 = shifted(img0, dx, dy)
    uv = _features(seed + 1)
    guess = uv + np.random.default_rng(seed + 2).normal(
        0, 0.7, uv.shape).astype(np.float32)
    return img0, img1, uv, guess


def _uv_ok_agreement(tuv, tok, juv, jok, tol, share):
    tuv, tok = tuv.numpy(), tok.numpy()
    juv, jok = np.asarray(juv), np.asarray(jok)
    assert (tok == jok).mean() >= share
    both = tok & jok
    assert both.sum() > 0.5 * len(both)
    err = np.abs(tuv - juv).max(1)[both]
    assert err.max() <= tol, err.max()
    return err.max()


@pytest.mark.parametrize("seed,patch,iters", [(0, 9, 8), (4, 9, 8),
                                              (8, 5, 4), (12, 15, 3)])
def test_lk_level(seed, patch, iters):
    img0, img1, uv, guess = _level_case(seed)
    juv, jok = jklt._lk_level(jnp.asarray(img0), jnp.asarray(img1),
                              jnp.asarray(uv), jnp.asarray(guess), patch,
                              iters, 1e-4)
    tuv, tok = tklt._lk_level(t(img0), t(img1), t(uv), t(guess), patch,
                              iters, 1e-4)
    # observed: ok equal on every lane, max |uv| difference 6.1e-5 px
    _uv_ok_agreement(tuv, tok, juv, jok, 1e-4, 0.995)


def test_lk_level_dispatch():
    """A CPU tensor takes the plain versions: of one level, and of both
    passes with and without a guess.  The CUDA-only wrapper of the passes
    refuses it rather than fall back, and one level refuses a tensor on a
    card (there the levels run only inside the passes' launch)."""
    img0, img1, uv, guess = _level_case(0)
    a = tklt._lk_level(t(img0), t(img1), t(uv), t(guess), 9, 8, 1e-4)
    b = tklt._lk_level_reference(t(img0), t(img1), t(uv), t(guess), 9, 8,
                                 1e-4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    pyr0 = tklt.build_pyramid(t(img0), LEVELS)
    pyr1 = tklt.build_pyramid(t(img1), LEVELS)
    for g in (t(guess), None):
        got = tklt._track_passes(pyr0, pyr1, t(uv), g, 9, 8, 1e-4)
        want = tklt._track_passes_reference(pyr0, pyr1, t(uv), g, 9, 8, 1e-4)
        assert len(got) == 4
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    # no guess: the forward pass starts at uv
    same = tklt._track_passes_reference(pyr0, pyr1, t(uv), t(uv), 9, 8, 1e-4)
    assert all(torch.equal(x, y) for x, y in zip(got, same))
    with pytest.raises(ValueError, match="CUDA"):
        tklt._track_passes_cuda(pyr0, pyr1, t(uv), t(guess), 9, 8, 1e-4)
    with pytest.raises(ValueError, match="CPU tensors"):
        tklt._lk_level(OnCard(t(img0)), OnCard(t(img1)), t(uv), t(guess), 9,
                       8, 1e-4)
    assert tklt.launches == 0


@pytest.mark.parametrize("levels", [1, 3, 4])
@pytest.mark.parametrize("patch", [5, 9, 15])
def test_track_passes_reference_matches_jax(levels, patch):
    """Both passes of the port's plain version against the JAX package's
    `_pyramidal` forward, then backward from the forward result, on the
    same numpy pyramids, from the corners `track_features` is given (the
    border cases are held level by level in `test_lk_level`); the
    tolerance of `test_track_features`."""
    seed = levels + patch
    img0 = textured(seed)
    img1 = shifted(img0, 3.1, -1.7)
    juv0, _ = jharris.detect_features(jnp.asarray(img0), LANES)
    uv = np.asarray(juv0)
    guess = (uv + np.float32([3.1, -1.7]) + np.random.default_rng(
        seed).normal(0, 0.7, uv.shape)).astype(np.float32)
    jp0 = jklt.build_pyramid(jnp.asarray(img0), levels)
    jp1 = jklt.build_pyramid(jnp.asarray(img1), levels)
    juv_f, jok_f = jklt._pyramidal(jp0, jp1, jnp.asarray(uv), patch, 8, 1e-4,
                                   guess=jnp.asarray(guess))
    juv_b, jok_b = jklt._pyramidal(jp1, jp0, juv_f, patch, 8, 1e-4,
                                   guess=jnp.asarray(uv))
    tp0 = [t(np.asarray(x)) for x in jp0]
    tp1 = [t(np.asarray(x)) for x in jp1]
    uv_f, ok_f, uv_b, ok_b = tklt._track_passes_reference(
        tp0, tp1, t(uv), t(guess), patch, 8, 1e-4)
    assert uv_f.dtype == uv_b.dtype == torch.float32
    assert ok_f.dtype == ok_b.dtype == torch.bool
    _uv_ok_agreement(uv_f, ok_f, juv_f, jok_f, 1e-4, 0.995)
    # The backward pass on the lanes that can pass the gate's
    # forward-backward test (back within 1 px in JAX, forward well
    # conditioned in both): a lane that lost its track wanders tens of px
    # and carries the two rounding orders apart (3.1e-3 px on one such
    # lane of 64).
    back = (ok_f.numpy() & np.asarray(jok_f)
            & (np.linalg.norm(np.asarray(juv_b) - uv, axis=1) < 1.0))
    assert back.mean() > 0.75
    _uv_ok_agreement(uv_b, ok_b & t(back), juv_b, np.asarray(jok_b) & back,
                     1e-4, 0.995)
    # the passes did track: the forward pass found the shift
    moved = (uv_f.numpy() - uv)[ok_f.numpy()]
    assert np.median(np.abs(moved - [3.1, -1.7])) < 0.1


@pytest.mark.parametrize("what,match", [
    ("even patch", "patch must be odd"),
    ("patch 17", "patch must be odd and at most 15"),
    ("negative iters", "iters must not be negative"),
    ("no levels", "pyramids of 1 to 8 levels, got 0"),
    ("too many levels", "pyramids of 1 to 8 levels, got 9"),
    ("level counts", "the pyramids must have the same levels, got 4 and 3"),
    ("level shapes", r"level 2: images must be \[H, W\] of one shape"),
    ("empty level", r"level 3: images must be \[H, W\]"),
    ("3-d image", r"level 0: images must be \[H, W\]"),
    ("f64 image", r"prev_pyr\[1\] must be torch.float32"),
    ("f64 guess", "guess must be torch.float32"),
    ("uv shape", r"uv must be \[64, 2\]"),
    ("guess rows", r"guess must be \[64, 2\]"),
    ("strided uv", "uv must be contiguous"),
    ("strided image", r"next_pyr\[0\] must be contiguous"),
    ("other device", "guess must be torch.float32 on cuda:0"),
    ("image on the cpu", r"next_pyr\[2\] must be torch.float32 on cuda:0, "
                         "got torch.float32 on cpu"),
])
def test_track_passes_cuda_argument_checks(what, match):
    """Every refusal of the passes' wrapper, reached with stand-ins for
    tensors on a card: patch, iterations, level count, pyramids that do
    not match level for level, dtype, shape, stride, device."""
    img0, img1, uv, guess = _level_case(0)
    real0 = tklt.build_pyramid(t(img0), 4)
    real1 = tklt.build_pyramid(t(img1), 4)
    pyr0, pyr1 = [OnCard(x) for x in real0], [OnCard(x) for x in real1]
    f_uv, f_guess = OnCard(t(uv)), OnCard(t(guess))
    patch, iters = 9, 8
    if what == "even patch":
        patch = 8
    elif what == "patch 17":
        patch = 17
    elif what == "negative iters":
        iters = -1
    elif what == "no levels":
        pyr0, pyr1 = [], []
    elif what == "too many levels":
        pyr0, pyr1 = pyr0 * 2 + pyr0[:1], pyr1 * 2 + pyr1[:1]
    elif what == "level counts":
        pyr1 = pyr1[:3]
    elif what == "level shapes":
        pyr1[2] = OnCard(real1[2], shape=(32, 47))
    elif what == "empty level":
        pyr0[3] = OnCard(real0[3], shape=(0, 24))
        pyr1[3] = OnCard(real1[3], shape=(0, 24))
    elif what == "3-d image":
        pyr0[0] = OnCard(real0[0], shape=(1, 128, 192))
    elif what == "f64 image":
        pyr0[1] = OnCard(real0[1], dtype=torch.float64)
    elif what == "f64 guess":
        f_guess = OnCard(t(guess), dtype=torch.float64)
    elif what == "uv shape":
        f_uv = OnCard(t(uv), shape=(64, 3))
    elif what == "guess rows":
        f_guess = OnCard(t(guess), shape=(63, 2))
    elif what == "strided uv":
        f_uv = OnCard(t(uv), contiguous=False)
    elif what == "strided image":
        pyr1[0] = OnCard(real1[0], contiguous=False)
    elif what == "other device":
        f_guess.device = torch.device("cuda", 1)
    elif what == "image on the cpu":
        pyr1[2] = real1[2]
    with pytest.raises(ValueError, match=match):
        tklt._track_passes_cuda(pyr0, pyr1, f_uv, f_guess, patch, iters,
                                1e-4)
    assert tklt.launches == 0


@pytest.mark.parametrize("seed,shift,warm", [(0, (2.3, 1.4), False),
                                             (1, (5.5, -3.2), True),
                                             (2, (-1.25, 0.6), False)])
def test_track_features(seed, shift, warm):
    img0 = textured(seed)
    img1 = shifted(img0, *shift)
    juv0, jok0 = jharris.detect_features(jnp.asarray(img0), LANES)
    uv, valid = np.asarray(juv0), np.asarray(jok0)
    guess = uv + np.asarray(shift, np.float32) if warm else None
    jp0 = jklt.build_pyramid(jnp.asarray(img0), LEVELS)
    jp1 = jklt.build_pyramid(jnp.asarray(img1), LEVELS)
    juv, jok = jklt.track_features(
        jp0, jp1, jnp.asarray(uv), jnp.asarray(valid),
        uv_guess=None if guess is None else jnp.asarray(guess))
    # both sides track on the JAX pyramids, so only the tracker differs
    tp0 = [t(np.asarray(x)) for x in jp0]
    tp1 = [t(np.asarray(x)) for x in jp1]
    tuv, tok = tklt.track_features(
        tp0, tp1, t(uv), t(valid),
        uv_guess=None if guess is None else t(guess))
    # observed: ok equal on every lane, max |uv| difference 3.8e-6 px
    _uv_ok_agreement(tuv, tok, juv, jok, 1e-4, 0.995)
    flow = (tuv.numpy() - uv)[tok.numpy()]
    assert np.abs(np.median(flow, 0) - shift).max() < 0.1
    with pytest.raises(ValueError, match="odd"):
        tklt.track_features(tp0, tp1, t(uv), t(valid), patch=8)


@pytest.mark.parametrize("keep", [
    [1, 1, 1, 1, 0, 0], [1, 0, 1, 1, 0, 1, 1], [0, 0, 0], [0, 1, 0],
    [1, 1]])
def test_nanmedian_matches_jax(keep):
    """Even counts average the two middle values (torch.nanmedian would
    take the lower one); no kept row gives NaN, then 0."""
    rng = np.random.default_rng(len(keep))
    x = rng.normal(size=(len(keep), 2)).astype(np.float32)
    keep = np.asarray(keep, bool)
    want = jnp.nanmedian(jnp.where(jnp.asarray(keep)[:, None],
                                   jnp.asarray(x), jnp.nan), axis=0)
    got = tfe._nanmedian0(t(x), t(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(torch.nan_to_num(got).numpy(),
                                  np.asarray(jnp.nan_to_num(want)))
    if keep.sum() == 4:
        lower = torch.nanmedian(t(np.where(keep[:, None], x, np.nan)),
                                dim=0).values
        assert not torch.equal(lower, got)


def test_set_drop():
    base = torch.arange(5, dtype=torch.int32)
    idx = torch.tensor([5, 1, 5, 3], dtype=torch.int32)
    vals = torch.tensor([90, 91, 92, 93], dtype=torch.int32)
    want = jnp.arange(5, dtype=jnp.int32).at[jnp.asarray(idx.numpy())].set(
        jnp.asarray(vals.numpy()), mode="drop")
    np.testing.assert_array_equal(tfe._set_drop(base, idx, vals).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(tfe._set_drop(base, idx, 7).numpy(),
                                  [0, 7, 2, 7, 4])
    assert torch.equal(base, torch.arange(5, dtype=torch.int32))


def test_init_tracker():
    img = textured(11)
    js = jfe.init_tracker(jnp.asarray(img), LANES, levels=LEVELS)
    ts = tfe.init_tracker(t(img), LANES, levels=LEVELS)
    want = to_numpy(js)
    got = state_to_numpy(ts)
    for name in ("uv", "ids", "age", "valid", "next_id", "flow"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    assert len(got.pyramid) == LEVELS


def test_tracker_state_converts():
    img = textured(11)
    js = jfe.init_tracker(jnp.asarray(img), LANES, levels=LEVELS)
    ts = to_port(js)
    assert isinstance(ts, tfe.TrackerState)
    assert isinstance(ts.pyramid, tuple) and len(ts.pyramid) == LEVELS
    assert_trees_equal(state_to_numpy(ts), to_numpy(js))
    out = jfe.TrackerOutput(ids=js.ids, valid=js.valid, uv_new=js.uv,
                            uv_prev=js.uv)
    assert isinstance(to_port(out), tfe.TrackerOutput)


@pytest.mark.parametrize("lanes", [64, 128])
def test_track_frame_sequence(lanes):
    """Six frames of a shifting texture, the port starting from the
    converted JAX state: ids, age, valid, next_id bit-exact on every
    frame, uv and flow within 1e-3 px.  128 lanes exceed the 96 cells."""
    base = textured(21, H + 32, W + 32)
    steps = [(0, 0), (2.3, 1.1), (4.1, 1.7), (5.6, 3.2), (8.0, 4.4),
             (9.5, 6.3)]
    imgs = [np.ascontiguousarray(shifted(base, dx, dy)[16:16 + H, 16:16 + W])
            for dx, dy in steps]
    for img in imgs[3:]:  # a flat occluder: the tracks under it are lost
        img[40:90, 60:130] = 0.5
    js = jfe.init_tracker(jnp.asarray(imgs[0]), lanes, levels=LEVELS)
    ts = to_port(js)
    emitted = 0
    for img in imgs[1:]:
        js, jout = jfe.track_frame(js, jnp.asarray(img))
        ts, tout = tfe.track_frame(ts, t(img))
        want, got = to_numpy(js), state_to_numpy(ts)
        for name in ("ids", "age", "valid", "next_id"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
            assert getattr(got, name).dtype == getattr(want, name).dtype
        # observed max difference 7.6e-6 px
        np.testing.assert_allclose(got.uv, want.uv, atol=1e-3, rtol=0)
        np.testing.assert_allclose(got.flow, want.flow, atol=1e-3, rtol=0)
        wout, gout = to_numpy(jout), state_to_numpy(tout)
        np.testing.assert_array_equal(gout.ids, wout.ids)
        np.testing.assert_array_equal(gout.valid, wout.valid)
        np.testing.assert_allclose(gout.uv_new, wout.uv_new, atol=1e-3,
                                   rtol=0)
        np.testing.assert_allclose(gout.uv_prev, wout.uv_prev, atol=1e-3,
                                   rtol=0)
        emitted += int(gout.valid.sum())
    assert emitted > 2 * lanes  # the sequence is trackable
    assert int(ts.next_id) > lanes  # lost lanes were replenished


def test_dev_img_scaling():
    """`_dev_img` divides by 255; XLA's CPU backend multiplies by the
    reciprocal instead, so the two images may differ in the last ulp.
    The parity tests therefore feed both sides one f32 image."""
    from mono_lidar_depth_tpu.eval import kitti_eval as jeval
    from mono_lidar_depth_tpu_torch.eval import kitti_eval as teval

    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = teval._dev_img(t(u8)).numpy()
    want = np.asarray(jax.jit(jeval._dev_img)(jnp.asarray(u8)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, u8.astype(np.float32) / 255.0)
    ulp = np.spacing(np.float32(1.0))
    assert np.abs(got - want).max() <= ulp  # observed: 6e-8 on some bytes


def test_plain_paths_launch_no_kernel():
    """On the CPU no tracker wrapper counts a launch: not `track_frame`,
    not `track_features` and not the passes' dispatcher."""
    before = (tklt.launches, tklt.gate_launches, twindows.launches)
    img = textured(0)
    ts = tfe.init_tracker(t(img), LANES, levels=LEVELS)
    tfe.track_frame(ts, t(shifted(img, 1.5, 1)))
    pyr0 = tklt.build_pyramid(t(img), LEVELS)
    pyr1 = tklt.build_pyramid(t(shifted(img, 1.5, 1)), LEVELS)
    uv, valid = tharris.detect_features(t(img), LANES)
    tklt.track_features(pyr0, pyr1, uv, valid)
    tklt._track_passes(pyr0, pyr1, uv, None, 9, 8, 1e-4)
    assert (tklt.launches, tklt.gate_launches, twindows.launches) == before
    assert tklt.launches == 0
    assert "device" not in inspect.signature(tfe.track_frame).parameters
