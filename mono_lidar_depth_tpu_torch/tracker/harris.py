"""Shi-Tomasi corner detection, grid-bucketed for static shapes
(counterpart of tracker/harris.py).

The image never leaves the device; gradients and the structure tensor
are convolutions, and non-max suppression is a grid reduction — one
corner per spatial cell, top-N cells by response — which yields a fixed
[N, 2] feature tensor with a validity mask instead of a dynamic keypoint
list.  Nothing here reads a value back to the host.

Against the JAX package: `F.conv2d` is a cross-correlation with zero
padding, as `lax.conv_general_dilated` with "SAME" padding is (neither
flips the kernel); the selection uses a stable descending sort, which
orders equal responses by ascending cell index as `lax.top_k` does
(`torch.topk` promises no order among ties, and every masked cell ties
at -inf).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _conv2d_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """2-D 'same' correlation of [H, W] with an odd [kh, kw] kernel."""
    kh, kw = kernel.shape
    return F.conv2d(img[None, None], kernel[None, None],
                    padding=(kh // 2, kw // 2))[0, 0]


@functools.lru_cache(maxsize=None)
def _sobel_kernels(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(kx, ky) on `device`; cached, so that only the first call copies
    host data to the device."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=torch.float32, device=device) / 8.0
    return kx, kx.T.contiguous()


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ix, Iy) Sobel gradients of [H, W] float image (1/8 scale)."""
    kx, ky = _sobel_kernels(img.device)
    return _conv2d_same(img, kx), _conv2d_same(img, ky)


def shi_tomasi_response(img: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Min-eigenvalue corner response of the structure tensor.

    lambda_min = (Sxx + Syy - sqrt((Sxx - Syy)^2 + 4 Sxy^2)) / 2
    with S* = box-filtered gradient products over `window`.
    """
    ix, iy = sobel_gradients(img.to(torch.float32))
    box = torch.ones((window, window), dtype=torch.float32,
                     device=img.device) / (window * window)
    sxx = _conv2d_same(ix * ix, box)
    syy = _conv2d_same(iy * iy, box)
    sxy = _conv2d_same(ix * iy, box)
    disc = torch.sqrt(torch.clamp((sxx - syy) ** 2 + 4.0 * sxy * sxy,
                                  min=0.0))
    return 0.5 * (sxx + syy - disc)


def select_features(
    resp: torch.Tensor,
    max_features: int,
    cell_size: int = 16,
    min_response: float = 1e-4,
    border: int = 8,
    occupied_uv: torch.Tensor | None = None,
    occupied_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The selection half of `detect_features`, on a given [H, W]
    response: border mask, best pixel per cell, occupied cells masked,
    top-N cells.  Returns (uv [N, 2] float32, valid [N] bool)."""
    H, W = resp.shape
    dev = resp.device
    neg_inf = float("-inf")
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    in_border = ((xx >= border) & (xx < W - border)
                 & (yy >= border) & (yy < H - border))
    resp = torch.where(in_border, resp, neg_inf)

    gh = (H + cell_size - 1) // cell_size
    gw = (W + cell_size - 1) // cell_size
    ph, pw = gh * cell_size, gw * cell_size
    resp_p = F.pad(resp, (0, pw - W, 0, ph - H), value=neg_inf)
    cells = resp_p.reshape(gh, cell_size, gw, cell_size).permute(0, 2, 1, 3)
    cells = cells.reshape(gh * gw, cell_size * cell_size)
    # argmax takes the first maximum; an all -inf cell gives 0
    best_in_cell = torch.argmax(cells, dim=1)
    best_resp = torch.gather(cells, 1, best_in_cell[:, None])[:, 0]

    if occupied_uv is not None:
        occ_x = (occupied_uv[:, 0] / cell_size).to(torch.int32)
        occ_y = (occupied_uv[:, 1] / cell_size).to(torch.int32)
        occ_cell = (torch.clamp(occ_y, 0, gh - 1) * gw
                    + torch.clamp(occ_x, 0, gw - 1)).long()
        if occupied_valid is None:
            occupied_valid = torch.ones(occupied_uv.shape[0],
                                        dtype=torch.bool, device=dev)
        # invalid lanes write the extra last slot, which is cut
        occupied_mask = torch.zeros(gh * gw + 1, dtype=torch.bool,
                                    device=dev)
        occupied_mask.index_fill_(
            0, torch.where(occupied_valid, occ_cell, gh * gw), True)
        best_resp = torch.where(occupied_mask[:-1], neg_inf, best_resp)

    # top-N cells by response (fewer cells than lanes → pad invalid)
    k = min(max_features, gh * gw)
    top_resp, top_cell = torch.sort(best_resp, descending=True, stable=True)
    top_resp, top_cell = top_resp[:k], top_cell[:k]
    if k < max_features:
        pad = max_features - k
        top_resp = F.pad(top_resp, (0, pad), value=neg_inf)
        top_cell = F.pad(top_cell, (0, pad), value=0)
    flat = best_in_cell[top_cell]
    cy = top_cell // gw
    cx = top_cell % gw
    py = cy * cell_size + flat // cell_size
    px = cx * cell_size + flat % cell_size
    uv = torch.stack([px, py], dim=1).to(torch.float32)
    valid = top_resp > min_response
    return uv, valid


def detect_features(
    img: torch.Tensor,
    max_features: int,
    cell_size: int = 16,
    min_response: float = 1e-4,
    border: int = 8,
    occupied_uv: torch.Tensor | None = None,
    occupied_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Detect up to `max_features` corners, at most one per cell.

    Args:
      img: [H, W] grayscale (any real dtype).
      max_features: fixed N of the output tensor.
      cell_size: spatial bucketing (also the enforced min distance
        between detections and to `occupied_uv` features).
      min_response: response floor.
      border: suppress detections within `border` px of the image edge.
      occupied_uv/[valid]: existing feature positions; their cells are
        masked out so detection only REPLENISHES free cells.

    Returns (uv [N, 2] float32, valid [N] bool), best-response-first.
    """
    return select_features(shi_tomasi_response(img), max_features,
                           cell_size, min_response, border, occupied_uv,
                           occupied_valid)
