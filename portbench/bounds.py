"""The least time the card could take for a piece of work: the larger of
its operations over the peak rate and its bytes over the memory bandwidth
(inputs read once, outputs written once). Peaks of one NVIDIA H100 SXM
(data sheet, dense, at its 700 W limit)."""

from __future__ import annotations

PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_F32 = 67e12  # FLOP/s, outside the tensor cores
HBM = 3.35e12  # bytes/s


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / HBM)


def fps_bound_s(clouds: int, points: int, picks: int) -> float:
    """Furthest point sampling of ``picks`` from ``points`` a cloud: each
    pick after the first updates every point (3 sub, 3 mul, 2 add, min,
    compare: 10 f32 operations); coordinates read, indices written."""
    return bound_s(10.0 * clouds * (picks - 1) * points, clouds * (points * 12 + picks * 4),
                   PEAK_F32)


def conv_bound_s(batch: int, r: int, cin: int, cout: int, element_bytes: int) -> float:
    """A 3x3x3 SAME conv + GroupNorm of a [batch, r, r, r, cin] grid to cout
    channels: 2 * 27 * cin * cout operations a voxel at the bf16 peak (the
    f32 peak for 4-byte elements); the grid, the weights and the output
    moved once."""
    ops = 2.0 * batch * r ** 3 * 27 * cin * cout
    nbytes = (batch * r ** 3 * (cin + cout) + 27 * cin * cout) * element_bytes
    return bound_s(ops, nbytes, PEAK_BF16 if element_bytes == 2 else PEAK_F32)
