"""Kernel K5's FPS (``csrc/fps.cu``), modelled on the CPU.

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

The cluster kernel (from 16,384 points) has a model of its own, held equal
to the plain version on random, all-tie, tied and lattice clouds, on
recombination-shaped ones and past the registers: each CTA's points in the
kernel's k-d order, each warp's rows cut into units with a bounding box
whose skip test must leave every distance it skips unchanged, each unit's
winner, then the CTA's (largest key, lowest index) and the 16 CTAs'
(largest key, lowest rank).
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


# ------------------------------------------------ the cluster kernel, modelled
def cluster_constants() -> dict:
    """fps_cluster_kernel's constants, parsed from csrc/fps.cu."""
    src = (kernels.CSRC / "fps.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    fewer = re.search(r"constexpr int kFewer\[\] = \{([\d, ]+)\};", src).group(1)
    return {"cluster": const["kCluster"], "threads": const["kClusterThreads"],
            "max_ppt": const["kMaxPPT"], "units": const["kUnits"],
            "offer_bytes": const["kOfferBytes"], "index_bits": const["kIndexBits"],
            "coord_bits": const["kCoordBits"], "fewer": [int(v) for v in fewer.split(",")]}


CLUSTER = cluster_constants()
F32_MAX = np.float32(np.finfo(np.float32).max)


def sqdist3(dx, dy, dz):
    """(dx*dx + dy*dy) + dz*dz in float32, every product and sum rounded on
    its own (csrc/common.cuh)."""
    return (dx * dx + dy * dy) + dz * dz


def cluster_layout(n: int, max_ppt: int = CLUSTER["max_ppt"]):
    """The cluster kernel's layout for a cloud of n: CTA c owns [c * chunk,
    (c + 1) * chunk), its warp w the positions [w * span, (w + 1) * span)
    of that, lane l of the warp the offsets 32 k + l (k < ppt in registers,
    the rest in the spill row). Without spill a warp's rows are cut into
    ``units`` units of ``rows`` rows (4, or units of 2 rows up to 4 rows);
    with it, one unit holds the whole span. -> dict with chunk, span, ppt,
    spill, units, rows, first [warps], count [warps]."""
    cl, warps = CLUSTER["cluster"], CLUSTER["threads"] // 32
    chunk = -(-n // cl)
    span = 32 * -(-chunk // CLUSTER["threads"])
    ppt = next((p for p in CLUSTER["fewer"] if span // 32 <= p and p < max_ppt), max_ppt)
    spill = span > 32 * ppt
    units = 1 if spill else (ppt // 2 if ppt <= CLUSTER["units"] else CLUSTER["units"])
    c, w = np.divmod(np.arange(cl * warps), warps)
    first = c * chunk + w * span
    count = np.clip(np.minimum(np.minimum(span, chunk - w * span), n - first), 0, None)
    return {"chunk": chunk, "span": span, "ppt": ppt, "spill": spill, "units": units,
            "rows": ppt // units, "first": first, "count": count}


def kd_order(xc: np.ndarray, lay: dict) -> np.ndarray:
    """The kernel's k-d order of one CTA's points xc [count, 3] f32: the
    local index at each position. The leaves are the CTA's units (16 warps
    x ``units``); each split sorts every node's points by (node, its longest
    axis quantised, index) and cuts at a unit boundary; the last sort
    orders each unit by index."""
    count, bits = len(xc), CLUSTER["index_bits"]
    span, units, unit_len = lay["span"], lay["units"], 32 * lay["rows"]
    levels = int(np.log2(CLUSTER["threads"] // 32 * units))
    steps = np.float32((1 << CLUSTER["coord_bits"]) - 1)
    pos = np.arange(count)
    unit = (pos // span) * units + np.minimum((pos % span) // unit_len, units - 1)
    idx = np.arange(count, dtype=np.uint32)
    for level in range(levels + 1):
        if level == levels:
            key = (unit.astype(np.uint32) << bits) | idx
        else:
            node = unit >> (levels - level)
            key = np.zeros(count, np.uint32)
            for nd in np.unique(node):
                at = node == nd
                p = xc[idx[at]]
                lo, ext = p.min(axis=0), p.max(axis=0) - p.min(axis=0)
                ex, ey, ez = ext
                axis = (2 if ez > ey else 1) if ey > ex else (2 if ez > ex else 0)
                scale = steps / ext[axis] if ext[axis] > 0 else np.float32(0)
                q = np.minimum(np.maximum((p[:, axis] - lo[axis]) * scale, np.float32(0)), steps)
                key[at] = ((np.uint32(nd) << (CLUSTER["coord_bits"] + bits))
                           | (q.astype(np.uint32) << bits) | idx[at])
        idx = np.sort(key) & np.uint32((1 << bits) - 1)
    return idx


def model_cluster_fps(x: np.ndarray, m: int, max_ppt: int = CLUSTER["max_ppt"],
                      check_skips: bool = False):
    """fps_cluster_kernel's picks for one cloud x [N, 3] f32, its count of
    skipped unit passes (of units that hold points) and of all unit passes.
    With ``check_skips``, every skipped unit's distances are recomputed and
    must be unchanged by the pick."""
    n = len(x)
    lay = cluster_layout(n, max_ppt)
    chunk, span, units, first, count = (lay[k] for k in ("chunk", "span", "units", "first",
                                                          "count"))
    cl, warps = CLUSTER["cluster"], CLUSTER["threads"] // 32
    order = np.arange(n)  # the point at each position
    if not lay["spill"]:  # k-d order within each CTA
        for c in range(cl):
            at = slice(c * chunk, min(n, (c + 1) * chunk))
            if at.start < at.stop:
                order[at] = at.start + kd_order(x[at], lay)
    # units [warp * units + u]: offsets [u0, u1) of the warp's span
    unit_len = 32 * lay["rows"]
    u0 = np.tile(np.arange(units) * unit_len, len(first))
    u1 = u0 + (span if lay["spill"] else unit_len)
    wfirst, wcount = np.repeat(first, units), np.repeat(count, units)
    offset = np.arange(u1[0] - u0[0])
    real = (u0[:, None] + offset[None, :]) < wcount[:, None]  # [unit, offset in it]
    index = np.where(real, order[np.minimum(wfirst[:, None] + u0[:, None] + offset[None, :],
                                            n - 1)], 0)
    lanes = (u0[:, None] + offset[None, :]) % 32
    xyz = np.where(real[..., None], x[index], np.float32(0))
    dist = np.where(real, F32_MAX, np.float32(-1))
    inf = np.float32(np.inf)
    lo = np.where(real[..., None], xyz, inf).min(axis=1)  # the units' boxes
    hi = np.where(real[..., None], xyz, -inf).max(axis=1)
    holding = real[:, 0]
    ud = np.where(holding, F32_MAX, np.float32(-1))  # each unit's winner
    ui = index[:, 0].astype(np.uint32)
    uxyz = xyz[:, 0].copy()
    out = np.zeros(m, np.int32)
    last = x[0]
    skipped = 0
    for j in range(1, m):
        g = np.where(last < lo, lo - last, np.where(last > hi, last - hi, np.float32(0)))
        skip = sqdist3(g[:, 0], g[:, 1], g[:, 2]) >= ud
        skipped += int((skip & holding).sum())
        run = np.flatnonzero(~skip)
        if check_skips:
            held = np.flatnonzero(skip & holding)
            d = xyz[held] - last
            d = sqdist3(d[..., 0], d[..., 1], d[..., 2])
            r = real[held]
            assert np.array_equal(np.minimum(dist[held], d)[r], dist[held][r]), j
        for u in run:
            d = xyz[u] - last
            dd = np.where(real[u], np.minimum(dist[u], sqdist3(d[:, 0], d[:, 1], d[:, 2])),
                          dist[u])
            dist[u] = dd
            # each lane's first maximum over its ascending offsets, then the
            # unit's largest distance and lowest offset holding it (offsets
            # ascend with indices within a unit)
            bits = np.where(dd >= 0, dd.view(np.uint32), np.uint32(0))
            best = bits.max()
            o = int(np.flatnonzero((bits == best) & real[u])[0])
            ud[u], ui[u], uxyz[u] = best.view(np.float32), index[u, o], xyz[u, o]
            assert lanes[u, o] == (u0[u] + o) % 32
        # each CTA's winner: its units' largest key, then the lowest index
        # holding it; then the 16 CTAs' largest key and the lowest rank
        key = np.where(holding, ud.view(np.uint32) + np.uint32(1), np.uint32(0))
        key, idx = key.reshape(cl, -1), np.where(holding, ui, NONE).reshape(cl, -1)
        cta_key = key.max(axis=1)
        w = np.argmin(np.where(key == cta_key[:, None], idx, NONE), axis=1)
        rank = int(np.argmax(cta_key))
        win = rank * key.shape[1] + w[rank]
        out[j] = ui[win]
        last = uxyz[win].copy()
    return out, skipped, int(holding.sum()) * (m - 1)


def tied_across(rng, n: int, bounds) -> np.ndarray:
    """A tied cloud (every point twice, on a grid) whose point at each of
    ``bounds`` repeats the one before: ties across warps' spans and CTAs."""
    x = tied_cloud(rng, n)
    for c in bounds:
        if 0 < c < n:
            x[c] = x[c - 1]
    return x


def recombination_cloud(rng, n: int, patch: int, seed_k: int = 3) -> np.ndarray:
    """What the exact recombination receives: kNN patches of a surface
    cloud of n points around its FPS seeds, each in kNN order, one after
    another ([seed_k * n / patch * patch, 3])."""
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x = (x * (1 + 0.15 * np.sin(3 * x[:, :1])) + 0.01 * rng.normal(size=x.shape))
    x = torch.from_numpy(x.astype(np.float32))[None]
    seeds = fps_ops.furthest_point_sample_plain(x, int(seed_k * n / patch))
    idx = torch.sort(torch.cdist(x[0, seeds[0].long()], x[0]) ** 2, dim=1, stable=True)[1]
    return x[0, idx[:, :patch].reshape(-1)].numpy()


def spans_and_chunks(n: int) -> list:
    lay = cluster_layout(n)
    first = lay["first"][lay["count"] > 0].tolist()
    return sorted(set(first) | set(range(lay["chunk"], n, lay["chunk"])))


def cluster_cloud(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=(n, 3)).astype(np.float32)
    if kind == "all_tie":  # one point n times: every pick ties every index
        return np.tile(rng.normal(size=(1, 3)).astype(np.float32), (n, 1))
    if kind == "tied":  # duplicates, and ties across warps' spans and CTAs
        return tied_across(rng, n, spans_and_chunks(n))
    if kind == "lattice":  # a coarse grid: picks on the boxes' faces and edges
        return rng.integers(0, 4, size=(n, 3)).astype(np.float32)
    raise ValueError(kind)


# (points, samples): one or two warps a CTA, a ragged last CTA, the cluster
# kernel's smallest cloud and one with more points a lane
CLUSTER_SHAPES = [(33, 17), (1000, 250), (5000, 700), (16_389, 400), (40_000, 150)]


@pytest.mark.parametrize("kind", ["random", "all_tie", "tied", "lattice"])
@pytest.mark.parametrize("N,M", CLUSTER_SHAPES)
def test_cluster_model_matches_plain(N, M, kind):
    x = cluster_cloud(kind, N, N + M)
    want = fps_ops.furthest_point_sample_plain(torch.from_numpy(x)[None], M)[0].numpy()
    got, _, _ = model_cluster_fps(x, M, check_skips=kind != "random" or N < 10_000)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,patch,m", [(2000, 256, 2000), (6000, 2048, 2000)])
def test_cluster_model_on_a_recombination(n, patch, m):
    """The recombination's shape scaled down (28,672 -> 10,000 is 14
    patches of 2,048 of a 10k cloud, 3 x the points): equal to the plain
    FPS, every skip sound, and nearly every unit pass skipped, since a
    unit of the k-d order is a compact piece of the surface."""
    x = recombination_cloud(np.random.default_rng(n), n, patch)
    want = fps_ops.furthest_point_sample_plain(torch.from_numpy(x)[None], m)[0].numpy()
    got, skipped, passes = model_cluster_fps(x, m, check_skips=True)
    np.testing.assert_array_equal(got, want)
    assert skipped / passes > 0.9


@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("max_ppt,N,M", [(2, 20_000, 300), (CLUSTER["max_ppt"], 170_000, 24)])
def test_cluster_model_past_the_registers(max_ppt, N, M, kind):
    """Spans longer than the registers (the kernel's N above 163,840; with
    2 points a lane, from 16,385): the rest of each span in the spill row,
    inside the warp's box, scanned after the registers."""
    assert cluster_layout(N, max_ppt)["spill"]
    x = cluster_cloud(kind, N, N)
    want = fps_ops.furthest_point_sample_plain(torch.from_numpy(x)[None], M)[0].numpy()
    got, _, _ = model_cluster_fps(x, M, max_ppt, check_skips=True)
    np.testing.assert_array_equal(got, want)


def test_cluster_constants_are_the_kernels():
    """The model's layout is the kernel's: 16 CTAs of 512 threads, winners
    of 16 bytes, spans of 608 and 128 points at the exact recombination's
    two sizes cut into 4 units of 5 rows and 2 of 2, 20 points a lane at most
    (past that, one unit a warp and a spill row), k-d keys of a 14-bit
    index and a 12-bit coordinate."""
    assert (CLUSTER["cluster"], CLUSTER["threads"], CLUSTER["offer_bytes"]) == (16, 512, 16)
    assert (CLUSTER["index_bits"], CLUSTER["coord_bits"], CLUSTER["units"]) == (14, 12, 4)
    assert CLUSTER["fewer"] == [2, 4, 8, 12, 16] and CLUSTER["max_ppt"] == 20
    pick = ("span", "ppt", "units", "rows", "spill")
    assert [cluster_layout(149_504)[k] for k in pick] == [608, 20, 4, 5, False]
    assert [cluster_layout(28_672)[k] for k in pick] == [128, 4, 2, 2, False]
    assert [cluster_layout(50_000)[k] for k in pick] == [224, 8, 4, 2, False]
    assert [cluster_layout(16_384)[k] for k in pick] == [64, 2, 1, 2, False]
    assert [cluster_layout(163_840)[k] for k in pick] == [640, 20, 4, 5, False]
    assert [cluster_layout(200_000)[k] for k in pick] == [800, 20, 1, 20, True]
    src = (kernels.CSRC / "fps.cu").read_text()
    assert "return 32 * ((chunk + kClusterThreads - 1) / kClusterThreads);" in src
    assert "static constexpr int R = SPILL ? 1 : (PPT <= kUnits ? PPT / 2 : kUnits);" in src
