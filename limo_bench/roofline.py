"""The least time one H100 could take for a function's work: the bytes
it must move (each input byte read once, each output byte written once)
over the device-memory rate, and its float32 operations over the float32
peak outside the tensor cores; the larger of the two.  The work is
counted from the function's own arguments, so a share reads the same
work whatever implements it.  The counts are `chip_smoke.py`'s
(`gather_bound_ms`) as they stood when the benchmark was defined.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12


class Work(tuple):
    """(bytes, flops) of one call."""

    def __new__(cls, nbytes: float, flops: float):
        return super().__new__(cls, (float(nbytes), float(flops)))

    @property
    def nbytes(self) -> float:
        return self[0]

    @property
    def flops(self) -> float:
        return self[1]

    def __add__(self, other):
        return Work(self[0] + other[0], self[1] + other[1])

    def least_s(self) -> float:
        """The least time: the larger of the two bounds."""
        return max(self[0] / PEAK_BYTES_S, self[1] / PEAK_FP32_S)


def gather_work(stack_shapes, n_lanes: int, scales, with_indices: bool
                ) -> Work:
    """One neighbor gather over plane stacks of `stack_shapes` [(C, H, W)]
    for `n_lanes` features: every stack and feature position read once;
    per scale and lane the mask, flags, z, points and, when asked, the
    indices of every window cell and the count written once; about 15
    float32 operations per cell (unpack, two pinhole products, masks)."""
    cells = sum(Ky * Kx for _, _, (Ky, Kx) in scales)
    per_cell = 1 + 1 + 4 + 12 + (4 if with_indices else 0)
    written = n_lanes * cells * per_cell + n_lanes * 4 * len(scales)
    read = sum(C * H * W * 4 for C, H, W in stack_shapes) + n_lanes * 8
    return Work(read + written, 15 * n_lanes * cells)


def gather_neighbors_frames_work(frames, uvs, camera, scales,
                                 with_indices: bool = True) -> Work:
    """`core/neighbors.gather_neighbors_frames` as called."""
    extra = 1 if with_indices else 0
    shapes = [(f.planes.shape[0] + extra, *f.planes.shape[1:])
              for f in frames]
    return gather_work(shapes, sum(uv.shape[0] for uv in uvs), scales,
                       with_indices)
