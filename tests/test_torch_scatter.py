"""The backward scatters of K3, K4 and K6 and kernel ``scatter_rows``'s
design, on the CPU.

The card holds ``scatter_rows`` bit-equal to the plain versions run on the
CPU, so their summation order is pinned here: ``index_add_`` adds the
entries one after another in entry order, in f32, from 0 (K3's corner by
corner). A numpy model of the kernel's algorithm is held bit-equal to the
plain versions: the segment table from a stable radix sort on the
destination, 8 bits a pass, in a cluster of CTAs (each a contiguous slice
of the pass's input, each warp a contiguous part of that, 32 entries at a
time ranked by digit; the counts scanned in (digit, CTA, warp) order), the
segment starts from the row counts, and each row's segment summed in
order (K3's weights recomputed from the coordinates). So is the kernel's
shape check, against every training call of the three configs and its
stated limits; the model's constants are parsed from the source.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config
from p2p_bridge_tpu_torch.ops import ball_query as bq_ops
from p2p_bridge_tpu_torch.ops import devoxelize as devox_ops
from p2p_bridge_tpu_torch.ops import interpolate as interp_ops
from p2p_bridge_tpu_torch.ops import scatter
from p2p_bridge_tpu_torch.utils.config import load_yaml

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
R = 8  # K3's grid resolution here
MODES = ("devoxelize", "ball_query_group", "three_nn_interpolate")
SOURCE = (kernels.CSRC / "scatter_rows.cu").read_text()
H100_SMS = 132


def constant(name: str) -> int:
    """A ``constexpr int`` of scatter_rows.cu: a number, 1 << n or a / 32."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE).group(1)
    if m := re.fullmatch(r"1 << (\w+)", expr):
        return 1 << (int(m.group(1)) if m.group(1).isdigit() else constant(m.group(1)))
    if m := re.fullmatch(r"(\w+) / 32", expr):
        return constant(m.group(1)) // 32
    return int(expr)


WARPS = constant("kWarps")
DIGIT_BITS = constant("kDigitBits")
MAX_CLUSTER = constant("kMaxCluster")
MIN_SLICE = constant("kMinSlice")
MAX_ROWS_PER_CTA = constant("kMaxRowsPerCta")


def six_decades(rng, *shape):
    """Values spread over six decades, so that f32 sums depend on their
    order."""
    return (rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 3, size=shape)).astype(np.float32)


def crowded_inputs(mode, seed, C=19):
    """A backward's inputs with a few dozen entries to a destination row:
    (grad [B, S, C] or [B, M, K, C], the op's other inputs, rows)."""
    rng = np.random.default_rng(seed)
    B = 2
    if mode == "devoxelize":  # 256 points in 3^3 voxels of an 8^3 grid, some on the grid
        coords = rng.uniform(R / 2 - 1, R / 2 + 1, size=(B, 256, 3)).astype(np.float32)
        coords[:, ::7] = np.round(coords[:, ::7])  # frac 0: the high corner has weight 0
        return six_decades(rng, B, 256, C), {"coords": coords}, R ** 3
    if mode == "ball_query_group":  # 64 centres x 8 rows onto 12 of 40 points
        idx = rng.integers(0, 12, size=(B, 64, 8)).astype(np.int32)
        return six_decades(rng, B, 64, 8, C), {"idx": idx}, 40
    # 300 points x 3 neighbours onto 10 centres
    idx = rng.integers(0, 10, size=(B, 300, 3)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, size=(B, 300, 3)).astype(np.float32)
    return six_decades(rng, B, 300, C), {"idx": idx, "weights": w}, 10


def corners(coords, r):
    """K3's corner rule in numpy f32, corner c = 4 cx + 2 cy + cz: [(rows
    [B, N], wx, wy, wz)]."""
    lo = np.floor(coords)
    frac = (coords - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    step = frac > 0
    w = {0: (np.float32(1.0) - frac).astype(np.float32), 1: np.where(step, frac, np.float32(0.0))}
    i = {0: lo, 1: lo + step}
    out = []
    for c in range(8):
        bits = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
        rows = (i[bits[0]][..., 0] * r + i[bits[1]][..., 1]) * r + i[bits[2]][..., 2]
        out.append((rows, w[bits[0]][..., 0], w[bits[1]][..., 1], w[bits[2]][..., 2]))
    return out


def entries(mode, grad, inputs, r=R):
    """Each cloud's entries in the plain version's order: (destination rows
    [B, E], terms [B, E, C] f32), every product rounded to f32 once."""
    g = grad.reshape(grad.shape[0], -1, grad.shape[-1])
    if mode == "ball_query_group":
        return inputs["idx"].reshape(g.shape[0], -1), g
    if mode == "three_nn_interpolate":
        w = inputs["weights"]
        terms = (w[..., None] * g[:, :, None, :]).astype(np.float32)
        return inputs["idx"].reshape(g.shape[0], -1), terms.reshape(g.shape[0], -1, g.shape[-1])
    dest, terms = [], []
    for rows, wx, wy, wz in corners(inputs["coords"], r):
        dest.append(rows)
        terms.append((wx * wy)[..., None] * (wz[..., None] * g))
    return np.concatenate(dest, 1), np.concatenate(terms, 1).astype(np.float32)


def sequential_sum(dest, terms, rows, order):
    """Per-row f32 sums from 0, one entry after another in ``order``."""
    B, _, C = terms.shape
    out = np.zeros((B, rows, C), np.float32)
    for b in range(B):
        for e in order:
            out[b, dest[b, e]] += terms[b, e]
    return out


def plain(mode, grad, inputs, rows, r=R):
    """The op's plain backward on the CPU, as its autograd Function calls it
    -> f32 [B, rows, C]."""
    g = torch.from_numpy(grad)
    if mode == "devoxelize":
        return devox_ops.trilinear_devoxelize_backward(g, torch.from_numpy(inputs["coords"]), r)
    if mode == "ball_query_group":
        return bq_ops.ball_query_group_backward(g, torch.from_numpy(inputs["idx"]), rows)
    return interp_ops.three_nn_interpolate_backward(
        g, torch.from_numpy(inputs["weights"]), torch.from_numpy(inputs["idx"]), rows)


def in_dtype(grad, dtype):
    """grad rounded to ``dtype`` and back: the values the kernel reads."""
    return torch.from_numpy(grad).to(dtype).float().numpy()


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_plain_backward_sums_in_entry_order(mode, dtype, threads):
    """Each plain backward is bit-equal to a sequential f32 numpy sum in
    entry order (K3: corner outer, point inner), with 1 or 4 threads, from a
    gradient in f32 or rounded to bf16; the reverse order gives other bits,
    so the comparison tells orders apart."""
    grad, inputs, rows = crowded_inputs(mode, MODES.index(mode))
    grad = in_dtype(grad, dtype)
    dest, terms = entries(mode, grad, inputs)
    want = sequential_sum(dest, terms, rows, range(dest.shape[1]))
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = plain(mode, grad, inputs, rows)
    finally:
        torch.set_num_threads(before)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    backwards = sequential_sum(dest, terms, rows, range(dest.shape[1] - 1, -1, -1))
    assert not np.array_equal(backwards, want)


def table_cluster(B, E, rows, sms=H100_SMS):
    """The kernel's cluster size (``table_cluster`` in the source): the
    largest power of two up to kMaxCluster with B * CL <= 2 * SMs and CL *
    kMinSlice <= E, but at least the CTAs the row counts need."""
    least = 1
    while least * MAX_ROWS_PER_CTA < rows:
        least *= 2
    cl = MAX_CLUSTER
    while cl > least and (B * cl > 2 * sms or cl * MIN_SLICE > E):
        cl //= 2
    return cl


def warp_parts(n_in, cl):
    """[lo, hi) of each warp's part of a pass's input, CTA-major: the CTA's
    contiguous slice, split among its warps as the kernel splits it."""
    parts = []
    n = -(-n_in // cl)
    for k in range(cl):
        lo, hi = min(k * n, n_in), min(k * n + n, n_in)
        m = -(-(hi - lo) // WARPS)
        for w in range(WARPS):
            wlo = min(lo + w * m, hi)
            parts.append((wlo, min(wlo + m, hi)))
    return np.array(parts, np.int64)


def radix_pass(seq_e, seq_d, shift, cl):
    """One pass of the kernel's table sort: each warp's part ranked 32
    entries at a time (a lane's rank among the earlier lanes of its digit,
    plus the warp's running count of that digit), the counts scanned in
    (digit, CTA, warp) order -> the pass's output (entries, destinations)."""
    n_in, digits = len(seq_e), 1 << DIGIT_BITS
    parts = warp_parts(n_in, cl)
    group = np.repeat(np.arange(len(parts)), parts[:, 1] - parts[:, 0])
    digit = (seq_d >> shift) & (digits - 1)
    hist = np.zeros((cl, WARPS, digits), np.int64)
    np.add.at(hist, (group // WARPS, group % WARPS, digit), 1)
    total = hist.sum(axis=(0, 1))
    base = np.cumsum(total) - total  # lower digits
    cta = hist.sum(axis=1)
    before = np.cumsum(cta, axis=0) - cta  # digit d in the CTAs before
    cursor = (np.cumsum(hist, axis=1) - hist) + (base + before)[:, None, :]
    cursor = cursor.reshape(cl * WARPS, digits)
    pos = np.full(n_in, -1, np.int64)
    lanes = np.arange(32)
    for step in range(int(-(-(parts[:, 1] - parts[:, 0]).max() // 32)) if n_in else 0):
        idx = parts[:, :1] + 32 * step + lanes  # [groups, 32]
        live = idx < parts[:, 1:]
        d = np.where(live, digit[np.minimum(idx, n_in - 1)], -1)
        same = (d[:, :, None] == d[:, None, :]) & live[:, None, :]
        rank = np.tril(same, -1).sum(axis=2)  # earlier lanes of the same digit
        g = np.broadcast_to(np.arange(len(parts))[:, None], d.shape)
        pos[idx[live]] = cursor[g[live], d[live]] + rank[live]
        np.add.at(cursor, (g[live], d[live]), 1)
    assert np.array_equal(np.sort(pos), np.arange(n_in))  # every slot once
    out_e, out_d = np.empty_like(seq_e), np.empty_like(seq_d)
    out_e[pos], out_d[pos] = seq_e, seq_d
    return out_e, out_d


def segment_table(dest, rows, cl):
    """The kernel's table for one cloud: (order [E], the entries by
    (destination, entry); start [rows + 1], each row's first slot, from the
    row counts each CTA owns, scanned CTA by CTA)."""
    order, seq_d = np.arange(len(dest)), dest.astype(np.int64)
    for p in range(2 if rows > 1 << DIGIT_BITS else 1):
        order, seq_d = radix_pass(order, seq_d, p * DIGIT_BITS, cl)
    rpc = -(-rows // cl)
    counts = np.zeros(cl * rpc, np.int64)
    np.add.at(counts, dest, 1)
    counts = counts.reshape(cl, rpc)
    local = np.cumsum(counts, axis=1) - counts
    range_total = counts.sum(axis=1)
    start = ((np.cumsum(range_total) - range_total)[:, None] + local).reshape(-1)[:rows]
    return order, np.append(start, len(dest))


def kernel_model(mode, grad, inputs, rows, r=R, cl=None):
    """scatter_rows's algorithm in numpy: per cloud the segment table of a
    cluster of ``cl`` CTAs (default: the kernel's choice on an H100), then
    each row the f32 sum of its segment's terms in table order, the term of
    entry e computed from e alone (K3: corner e // S of point e % S, its row
    and weights by the corner rule). -> f32 [B, rows, C]."""
    B, C = grad.shape[0], grad.shape[-1]
    dest, terms = entries(mode, grad, inputs, r)
    E = dest.shape[1]
    cl = cl or table_cluster(B, E, rows)
    out = np.zeros((B, rows, C), np.float32)
    for b in range(B):
        order, start = segment_table(dest[b], rows, cl)
        assert np.array_equal(order, np.argsort(dest[b], kind="stable"))
        length = np.diff(start)
        for j in range(int(length.max(initial=0))):
            v = np.flatnonzero(length > j)
            out[b, v] = (out[b, v] + terms[b, order[start[v] + j]]).astype(np.float32)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_algorithm_is_bit_equal_to_the_plain_backward(mode, dtype):
    """The kernel's order (sorted keys, segments) and its K3 weights give
    the plain backward's bits, before and after the one rounding to the
    gradient's dtype."""
    grad, inputs, rows = crowded_inputs(mode, 10 + MODES.index(mode))
    grad = in_dtype(grad, dtype)
    want = plain(mode, grad, inputs, rows)
    got = kernel_model(mode, grad, inputs, rows)
    np.testing.assert_array_equal(got, want.numpy())
    assert torch.equal(torch.from_numpy(got).to(dtype), want.to(dtype))


def backward_calls(config):
    """(B, S, E, R, C) of every backward scatter of a config's training
    step: K3 per PVConv, K4 per SA stage, K6 per FP stage."""
    cfg = load_yaml(str(CONFIGS / config))
    with torch.device("meta"):
        plan = build_unet_from_config(cfg).plan
    B, n, fine, calls = cfg["training"]["bs"], cfg["data"]["npoints"], [], set()
    for stage in plan.sa_stages:
        fine.append(n)
        calls |= {(B, n, 8 * n, spec.resolution ** 3, spec.out_channels) for spec in stage.convs}
        sa = stage.sa
        calls.add((B, sa.num_centers * sa.num_neighbors, sa.num_centers * sa.num_neighbors, n,
                   sa.in_channels + 3))
        n = sa.num_centers
    for i, stage in enumerate(plan.fp_stages):
        c_interp = stage.fp.in_channels - plan.skip_channels[-1 - i]
        calls.add((B, fine[-1 - i], 3 * fine[-1 - i], n, c_interp))
        n = fine[-1 - i]
        calls |= {(B, n, 8 * n, spec.resolution ** 3, spec.out_channels) for spec in stage.convs}
    return calls


@pytest.mark.parametrize("config", ["PVDS_PUNet.yaml", "PVDL_SNPP.yaml", "PVDL_ARKIT.yaml"])
def test_scatter_kernel_takes_every_training_call(config):
    """The kernel's shape check passes every backward scatter of the
    shipped configs at their training batch (PVDS_PUNet: at most 16,384
    entries a cloud; the rooms models: 32,768), and what the one-block sort
    refused past 2^15 entries or rows; it refuses more entries or rows than
    the table takes, more clouds than the grid takes, or offsets past 32
    bits."""
    calls = backward_calls(config)
    assert max(E for _, _, E, _, _ in calls) == (16384 if config == "PVDS_PUNet.yaml" else 32768)
    for call in calls:
        scatter.check_scatter_shape(*call)
    for call in ((1, 4097, 8 * 4097, 64, 32), (1, 64, 64, 2 ** 15 + 1, 32),
                 (4, 8192, 8 * 8192, 32 ** 3, 64), (1, 2 ** 14, 2 ** 17, 32 ** 3, 32),
                 (1, 2 ** 17, 2 ** 20, 32 ** 3, 32), (1, 64, 64, 2 ** 16, 32)):
        scatter.check_scatter_shape(*call)
    for B, S, E, rows, C in ((1, 2 ** 17 + 1, 8 * (2 ** 17 + 1), 64, 32),
                             (1, 64, 64, 2 ** 16 + 1, 32), (2 ** 16, 64, 64, 64, 32),
                             (1, 64, 0, 64, 32), (1, 2 ** 16, 2 ** 15, 64, 2 ** 15),
                             (1, 64, 64, 2 ** 16, 2 ** 15)):
        with pytest.raises(ValueError, match="scatter_rows kernel takes"):
            scatter.check_scatter_shape(B, S, E, rows, C)


def test_the_shape_limits_are_the_kernels():
    """The wrapper's limits are the C entry's, and the cluster covers the
    most rows: 2^16 rows need no more CTAs than a cluster has."""
    assert constant("MAX_ENTRIES") == scatter.MAX_ENTRIES == 2 ** 20
    assert constant("MAX_ROWS") == scatter.MAX_ROWS == 2 ** 16
    assert scatter.MAX_ROWS <= MAX_CLUSTER * MAX_ROWS_PER_CTA
    assert scatter.MAX_ROWS <= (1 << DIGIT_BITS) ** 2  # two digit passes
    for line in ("while (least * kMaxRowsPerCta < R) least *= 2;",
                 "((long long)B * CL > 2 * sms || CL * kMinSlice > E)) CL /= 2;",
                 "const int rpc = (R + CL - 1) / CL;", "R > kDigits ? 2 : 1"):
        assert line in SOURCE


@pytest.mark.parametrize("cl", [1, 4, 16])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_algorithm_at_every_cluster_size(mode, cl):
    """The model stays bit-equal to the plain backward for a cluster of 1,
    4 or 16 CTAs a cloud: warps with one partial chunk, warps and CTAs with
    no entries."""
    grad, inputs, rows = crowded_inputs(mode, 20 + MODES.index(mode))
    want = plain(mode, grad, inputs, rows)
    np.testing.assert_array_equal(kernel_model(mode, grad, inputs, rows, cl=cl), want.numpy())


def skewed_inputs(case, seed, C=5):
    """Backward inputs whose destinations are skewed or past the one-block
    sort's limit: (mode, grad, inputs, rows, r)."""
    rng = np.random.default_rng(seed)
    if case == "every entry to one row":  # K4, 2 x 256 centres x 32 slots onto row 7
        idx = np.full((2, 256, 32), 7, np.int32)
        return "ball_query_group", six_decades(rng, 2, 256, 32, C), {"idx": idx}, 300, R
    if case == "ball query padding":  # 1-4 hits a centre, the rest its first index
        idx = rng.integers(0, 1024, size=(2, 512, 32)).astype(np.int32)
        found = rng.integers(1, 5, size=(2, 512, 1))
        idx = np.where(np.arange(32) < found, idx, idx[..., :1]).astype(np.int32)
        return "ball_query_group", six_decades(rng, 2, 512, 32, C), {"idx": idx}, 1024, R
    if case == "one row across the slices' seam":  # K6 onto 600 rows, 3 x 4096 entries
        idx = rng.integers(0, 600, size=(1, 4096 * 3)).astype(np.int32)
        idx[0, 6144 - 1500:6144 + 1500] = 5  # across E / 2, a seam at every cluster size
        idx[0, ::97] = 599  # from every slice
        w = rng.uniform(0.0, 1.0, size=(1, 4096, 3)).astype(np.float32)
        return ("three_nn_interpolate", six_decades(rng, 1, 4096, C),
                {"idx": idx.reshape(1, 4096, 3), "weights": w}, 600, R)
    r, points = 32, {"just above the old limit": 4097, "at the new limit": 2 ** 17}[case]
    # K3 at r = 32, points uniform in the grid: 8 x points entries
    coords = rng.uniform(0.0, r - 1.0, size=(1, points, 3)).astype(np.float32)
    coords[:, ::5] = np.round(coords[:, ::5])
    return "devoxelize", six_decades(rng, 1, points, C), {"coords": coords}, r ** 3, r


SKEWED = ("every entry to one row", "ball query padding", "one row across the slices' seam",
          "just above the old limit", "at the new limit")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SKEWED)
def test_kernel_algorithm_on_skewed_and_large_inputs(case, dtype):
    """The model is bit-equal to the plain backward where one row takes
    every entry, where ball query's padding repeats a centre's first index,
    where a row's entries run across the CTAs' slices, and past 2^15
    entries up to the new limit of 2^20, at the cluster size the kernel
    takes for the shape and at a cluster of 16."""
    mode, grad, inputs, rows, r = skewed_inputs(case, SKEWED.index(case))
    grad = in_dtype(grad, dtype)
    B, E = grad.shape[0], entries(mode, grad, inputs, r)[0].shape[1]
    if case.startswith("just above"):
        assert E == 2 ** 15 + 8
    if case.startswith("at the new"):
        assert E == scatter.MAX_ENTRIES
    scatter.check_scatter_shape(B, grad.reshape(B, -1, grad.shape[-1]).shape[1], E, rows,
                                grad.shape[-1])
    want = plain(mode, grad, inputs, rows, r).numpy()
    for cl in sorted({table_cluster(B, E, rows), MAX_CLUSTER}):
        np.testing.assert_array_equal(kernel_model(mode, grad, inputs, rows, r, cl), want)
