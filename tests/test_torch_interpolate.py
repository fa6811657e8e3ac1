"""Kernel K6 (3-NN interpolation) on the CPU, free of jax.

The card holds K6's indices torch.equal to the plain version's, so the
kernel's scan is modelled here in numpy and held equal to the plain
``three_nn``: the centres staged ``kChunk`` at a time, each point's
centres split into S contiguous ranges over S lanes, each lane's running
top 3 in index order (strict <), then the lanes' lists merged in a
butterfly in (d2, index) order. The constants and the lane layout are
parsed from ``csrc/interpolate.cu``.
"""

import re

import numpy as np
import pytest
import torch

from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.ops import interpolate as interp_ops

SOURCE = (kernels.CSRC / "interpolate.cu").read_text()


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS, CHUNK, MAX_SPLIT, WAVES = (
    constant(n) for n in ("kThreads", "kChunk", "kMaxSplit", "kWaves"))
SPLITS = [1 << k for k in range(MAX_SPLIT.bit_length())]  # 1, 2, ..., kMaxSplit
H100_SMS = 132


def tile(S: int) -> int:
    return THREADS // S


def split_lanes(B: int, N: int, sms: int) -> int:
    """``split_lanes`` of the source: the fewest lanes a point that give
    the grid kWaves blocks per SM."""
    S = 1
    while S < MAX_SPLIT and B * -(-N // tile(S)) < WAVES * sms:
        S *= 2
    return S


def test_the_source_has_the_modelled_layout():
    """The lines the model follows, as the source writes them."""
    for line in ("const int G = 32 / S;", "const int tile = kThreads / S;",
                 "const int s = lane / G, g = lane - s * G;",
                 "const int local = warp * G + g;",
                 "const int len = (cnt + S - 1) / S;",
                 "const int lo = min(cnt, s * len), hi = min(cnt, lo + len);",
                 "for (int off = G; off < 32; off <<= 1) {",
                 "if (d < t.d[2]) push_scanned(t, d, m0 + j);",
                 # split_lanes, as modelled below
                 "while (S < kMaxSplit &&\n         (long long)B * ((N + kThreads / S - 1) / "
                 "(kThreads / S)) < (long long)kWaves * sms)\n    S *= 2;"):
        assert line in SOURCE, line


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("N", [1, 7, 300, 2048])
def test_every_point_has_its_lanes_once(S, N):
    """Blocks of the tile's points, S lanes a point (split-major lanes, so
    partners differ in the s bits only): every point of a ragged N is
    scanned by exactly its S lanes, one of each s."""
    G, seen = 32 // S, {}
    for block in range(-(-N // tile(S))):
        for tid in range(THREADS):
            warp, lane = divmod(tid, 32)
            s, g = divmod(lane, G)
            n = block * tile(S) + warp * G + g
            if n < N:
                seen.setdefault(n, []).append((warp, g, s))
    assert sorted(seen) == list(range(N))
    for lanes in seen.values():
        assert sorted(s for _, _, s in lanes) == list(range(S))
        assert len({(w, g) for w, g, _ in lanes}) == 1


@pytest.mark.parametrize("B,N,S", [(73, 32, 32), (73, 128, 8), (73, 512, 2), (73, 2048, 1),
                                   (32, 32, 32), (32, 128, 32), (32, 512, 8), (32, 2048, 2),
                                   (1, 100_000, 1)])
def test_split_covers_the_card(B, N, S):
    """At the main path's four stages (B = 73 denoising, 32 training) the
    grid reaches kWaves blocks per SM of an H100, or S is at its most."""
    assert split_lanes(B, N, H100_SMS) == S
    assert B * -(-N // tile(S)) >= WAVES * H100_SMS or S == MAX_SPLIT


def sqdist3(points: np.ndarray, c: np.ndarray) -> np.ndarray:
    """(dx*dx + dy*dy) + dz*dz in f32, one rounding an operation."""
    d = points - c
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def before(da, ia, db, ib):
    return (da < db) | ((da == db) & (ia < ib))


def push(d, i, dn, m, lt):
    """Insert (dn, m) into every point's sorted top 3 where lt(new, slot)."""
    c0, c1, c2 = (lt(dn, m, d[:, q], i[:, q]) for q in range(3))
    nd, ni = d.copy(), i.copy()
    nd[:, 2] = np.where(c1, d[:, 1], np.where(c2, dn, d[:, 2]))
    ni[:, 2] = np.where(c1, i[:, 1], np.where(c2, m, i[:, 2]))
    nd[:, 1] = np.where(c0, d[:, 0], np.where(c1, dn, d[:, 1]))
    ni[:, 1] = np.where(c0, i[:, 0], np.where(c1, m, i[:, 1]))
    nd[:, 0] = np.where(c0, dn, d[:, 0])
    ni[:, 0] = np.where(c0, m, i[:, 0])
    return nd, ni


def kernel_scan(points: np.ndarray, centers: np.ndarray, S: int):
    """One cloud's scan as the kernel runs it -> (d2 [N, 3], idx [N, 3])."""
    N, M = len(points), len(centers)
    lanes = []
    for s in range(S):
        d = np.full((N, 3), np.inf, np.float32)
        i = np.zeros((N, 3), np.int64)
        for m0 in range(0, M, CHUNK):
            cnt = min(CHUNK, M - m0)
            length = -(-cnt // S)
            lo = min(cnt, s * length)
            for j in range(lo, min(cnt, lo + length)):
                d, i = push(d, i, sqdist3(points, centers[m0 + j]), m0 + j,
                            lambda a, _, b, __: a < b)  # ascending index: strict <
        lanes.append((d, i))
    step = 1
    while step < S:  # the shuffle butterfly: partner lane ^ (G * step)
        merged = []
        for s in range(S):
            d, i = lanes[s]
            od, oi = lanes[s ^ step]
            for q in range(3):
                d, i = push(d, i, od[:, q], oi[:, q], before)
            merged.append((d, i))
        lanes, step = merged, 2 * step
    for d, i in lanes[1:]:  # every lane of a point holds the same list
        np.testing.assert_array_equal(d, lanes[0][0])
        np.testing.assert_array_equal(i, lanes[0][1])
    return lanes[0]


def kernel_weights(d: np.ndarray) -> np.ndarray:
    d = np.clip(d, np.float32(1e-10), np.float32(1e10))
    d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
    denom = (d0 * d1 + d0 * d2) + d1 * d2
    return np.stack([d1 * d2 / denom, d0 * d2 / denom, d0 * d1 / denom], axis=-1)


def cloud(seed, N, M, integer):
    """Fine points and centres; with ``integer`` small integer coordinates,
    so that many centres lie at exactly equal distances."""
    rng = np.random.default_rng(seed)
    if integer:
        return (rng.integers(-2, 3, size=(N, 3)).astype(np.float32),
                rng.integers(-2, 3, size=(M, 3)).astype(np.float32))
    return rng.random((N, 3)).astype(np.float32), rng.random((M, 3)).astype(np.float32)


# N, M, integer coordinates: ties, M < 3, M not a multiple of S, two chunks,
# N not a multiple of any tile
SCAN_CASES = [(61, 1, True), (61, 2, True), (61, 2, False), (257, 37, True), (257, 37, False),
              (100, 128, True), (33, 8, True), (70, CHUNK + 89, True), (70, CHUNK + 89, False)]


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("N,M,integer", SCAN_CASES)
def test_split_scan_equals_the_serial_scan(N, M, integer, S):
    """For every S: indices equal to the plain three_nn (first minimum
    three times), weights bit-equal; on integer clouds many of the
    picks are exact ties."""
    points, centers = cloud(N * M + S, N, M, integer)
    d, idx = kernel_scan(points, centers, S)
    w, want_idx = interp_ops.three_nn(torch.from_numpy(points)[None],
                                      torch.from_numpy(centers)[None])
    np.testing.assert_array_equal(idx, want_idx[0].numpy())
    np.testing.assert_array_equal(kernel_weights(d), w[0].numpy())
    if integer and M > 3:  # the case has ties among the picks
        ranked = np.sort(np.stack([sqdist3(points, c) for c in centers], axis=1), axis=1)
        assert (ranked[:, 2] == ranked[:, 3]).any()


def test_the_merge_order_decides_ties():
    """Three centres at one distance from a point, split over lanes in
    reverse: the merge still ranks them by index."""
    points = np.zeros((1, 3), np.float32)
    centers = np.array([[1, 0, 0], [0, 0, 2], [0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32)
    for S in SPLITS:
        np.testing.assert_array_equal(kernel_scan(points, centers, S)[1], [[0, 2, 3]])
