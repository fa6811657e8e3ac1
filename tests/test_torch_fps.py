"""Kernel K5's one-warp and one-block FPS (``csrc/fps.cu``), modelled on the
CPU.

The card holds the kernels' indices torch.equal to the plain version. Here
a numpy model of their reduction order is held equal to the plain version
and to the JAX package's XLA FPS, on random clouds and on clouds whose
every pick is a tie: each thread t of T holds points k * T + t and offers
its lowest-index maximum (a strict > over ascending k); a warp reduces its
lanes' offers as two redux.sync (the largest distance bits, then the lowest
index among the lanes holding them); the one-warp kernel (N <= 1024) takes
that winner, the one-block kernel writes each warp's winner with its
coordinates into a table double-buffered by pick parity and every warp
reduces the table the same way. Distances are >= 0, so their bits order as
the values, and a thread or warp without points offers bits 0 and no index.
"""

import re

import numpy as np
import pytest
import torch

from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.ops import fps as fps_ops

NONE = np.uint32(0xFFFFFFFF)  # the index of no point: loses every tie
WARP_MAX_POINTS = 1024  # csrc/fps.cu kWarpMaxPoints
BLOCK_PPT = 8  # csrc/fps.cu kBlockPPT


def threads(n: int) -> int:
    """Threads a cloud of n points gets (csrc/fps.cu): one warp up to 1,024
    points; above, the fewest of 128, 256, 512 and 1024 whose registers (8
    points a thread) hold the cloud, else 1024."""
    if n <= WARP_MAX_POINTS:
        return 32
    t = 128
    while t < 1024 and t * BLOCK_PPT < n:
        t *= 2
    return t


def redux(bits: np.ndarray, idx: np.ndarray):
    """The argmax of one warp's offers [..., 32]: the largest bits, then
    the lowest index among the lanes holding them; and that lane."""
    best = bits.max(axis=-1, keepdims=True)
    winner = np.where(bits == best, idx, NONE).min(axis=-1)
    lane = np.argmax((bits == best) & (idx == winner[..., None]), axis=-1)
    return best[..., 0], winner, lane


def model_fps(x: np.ndarray, m: int) -> np.ndarray:
    """The kernels' picks for one cloud x [N, 3] f32."""
    n = len(x)
    t = threads(n)
    rows = -(-n // t)  # k = 0 .. rows - 1 (registers, then shared memory)
    index = (np.arange(rows)[:, None] * t + np.arange(t)[None, :]).astype(np.uint32)
    real = index < n
    xyz = np.zeros((rows, t, 3), np.float32)
    xyz[real] = x[index[real]]
    dist = np.where(real, np.float32(np.finfo(np.float32).max), np.float32(-1.0))
    table = np.zeros((2, 32, 4), np.float32), np.full((2, 32), NONE)
    out = np.zeros(m, np.int32)
    last = x[0]
    for j in range(1, m):
        dx, dy, dz = (xyz[..., c] - last[c] for c in range(3))
        d = (dx * dx + dy * dy) + dz * dz  # f32, no FMA: sqdist3
        dist = np.where(real, np.minimum(dist, d), dist)
        k = np.argmax(dist, axis=0)  # each thread's first (lowest k) maximum
        bv = dist[k, np.arange(t)]
        has = bv >= 0
        bits = np.where(has, bv.view(np.uint32), np.uint32(0))
        bi = np.where(has, index[k, np.arange(t)], NONE)
        coords = xyz[k, np.arange(t)]
        wbits, widx, wlane = redux(bits.reshape(-1, 32), bi.reshape(-1, 32))
        wxyz = coords.reshape(-1, 32, 3)[np.arange(t // 32), wlane]
        if t == 32:
            win, last = widx[0], wxyz[0]
        else:
            par = j & 1
            nw = t // 32
            table[0][par, :nw, 0] = wbits.view(np.float32)
            table[0][par, :nw, 1:] = wxyz
            table[1][par, :nw] = widx
            sent = np.where(np.arange(32) < nw, table[1][par], NONE)
            sbits = np.where(np.arange(32) < nw, table[0][par, :, 0].view(np.uint32),
                             np.uint32(0))
            _, win, lane = redux(sbits, sent)
            last = table[0][par, lane, 1:]
        out[j] = win
    return out


def tied_cloud(rng, n: int) -> np.ndarray:
    """n points, each appearing twice at random places, on a 1/8 grid, and
    every 32nd index a copy of the one before: every pick ties, also across
    lanes and warps."""
    half = np.round(rng.normal(size=((n + 1) // 2, 3)) * 8) / 8
    x = np.concatenate([half, half])[rng.permutation(2 * len(half))][:n]
    for c in range(32, n, 32):
        x[c] = x[c - 1]
    return x.astype(np.float32)


def clouds(kind: str, b: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "tied":
        return np.stack([tied_cloud(rng, n) for _ in range(b)])
    return rng.normal(size=(b, n, 3)).astype(np.float32)


# (clouds, points, samples): the SA stages (32, 128, 512, 2048 points), odd
# N on both sides of the one-warp limit, every thread count of the block
# kernel, and a cloud past its registers (shared-memory points)
SHAPES = [(2, 32, 8), (2, 33, 17), (2, 128, 32), (2, 512, 128), (1, 1000, 250),
          (1, 1024, 64), (1, 1025, 64), (1, 2048, 160), (1, 4097, 96), (1, 9000, 48)]


@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("B,N,M", SHAPES)
def test_model_matches_plain(B, N, M, kind):
    x = clouds(kind, B, N, N + M)
    want = fps_ops.furthest_point_sample_plain(torch.from_numpy(x), M).numpy()
    got = np.stack([model_fps(c, M) for c in x])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("B,N,M", [(2, 33, 17), (1, 1025, 64), (1, 9000, 48)])
def test_model_matches_xla(B, N, M, kind):
    """Against p2p_bridge_tpu/ops/fps.py:_furthest_point_sample_xla."""
    import jax.numpy as jnp

    from p2p_bridge_tpu.ops.fps import _furthest_point_sample_xla

    x = clouds(kind, B, N, 7 * N + M)
    want = np.asarray(_furthest_point_sample_xla(jnp.asarray(x), M))
    got = np.stack([model_fps(c, M) for c in x])
    np.testing.assert_array_equal(got, want)


def test_model_constants_are_the_kernels():
    """The model's limits are those of csrc/fps.cu: one warp up to 1,024
    points, 8 points a thread in registers above, and the one-block kernel
    up to 16,383 points, one below the dispatch's cluster threshold."""
    src = (kernels.CSRC / "fps.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kWarpMaxPoints"]) == WARP_MAX_POINTS
    assert int(const["kBlockPPT"]) == BLOCK_PPT
    assert int(const["kBlockMaxPoints"]) == fps_ops.CLUSTER_MIN_POINTS - 1
    assert [threads(n) for n in (1, 32, 1024, 1025, 2048, 2049, 4096, 8192, 8193, 16383)] == \
        [32, 32, 32, 256, 256, 512, 512, 1024, 1024, 1024]


def test_tied_clouds_tie():
    """The tied clouds do tie: nearly every point has a copy at another
    index, so every pick has an equal-distance partner."""
    x = torch.from_numpy(clouds("tied", 1, 257, 3))
    d = torch.cdist(x[0], x[0])
    assert ((d == 0).sum(dim=1) >= 2).float().mean() > 0.9
