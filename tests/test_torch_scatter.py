"""The backward scatters of K3, K4 and K6 and kernel ``scatter_rows``'s
design, on the CPU.

The card holds ``scatter_rows`` bit-equal to the plain versions run on the
CPU, so their summation order is pinned here: ``index_add_`` adds the
entries one after another in entry order, in f32, from 0 (K3's corner by
corner). A numpy model of the kernel's algorithm (keys destination <<
bits | entry, sorted; each row's segment summed in sorted order; K3's
weights recomputed from the coordinates) is held bit-equal to the plain
versions, and the kernel's shape check to every training call of the
three configs.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config
from p2p_bridge_tpu_torch.ops import ball_query as bq_ops
from p2p_bridge_tpu_torch.ops import devoxelize as devox_ops
from p2p_bridge_tpu_torch.ops import interpolate as interp_ops
from p2p_bridge_tpu_torch.ops import scatter
from p2p_bridge_tpu_torch.utils.config import load_yaml

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
R = 8  # K3's grid resolution here
MODES = ("devoxelize", "ball_query_group", "three_nn_interpolate")


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


def entries(mode, grad, inputs):
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
    for rows, wx, wy, wz in corners(inputs["coords"], R):
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


def plain(mode, grad, inputs, rows):
    """The op's plain backward on the CPU, as its autograd Function calls it
    -> f32 [B, rows, C]."""
    g = torch.from_numpy(grad)
    if mode == "devoxelize":
        return devox_ops.trilinear_devoxelize_backward(g, torch.from_numpy(inputs["coords"]), R)
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


def kernel_model(mode, grad, inputs, rows):
    """scatter_rows's algorithm in numpy: per cloud the keys dest << ebits |
    e, sorted; the segment starts by binary search; each row the f32 sum of
    its segment's terms in sorted order, the term of entry e computed from
    e alone (K3: corner e // S of point e % S, its row and weights by the
    corner rule). -> f32 [B, rows, C]."""
    B, C = grad.shape[0], grad.shape[-1]
    g = grad.reshape(B, -1, C)
    S = g.shape[1]
    E = {"ball_query_group": S, "three_nn_interpolate": 3 * S, "devoxelize": 8 * S}[mode]
    ebits = max(E - 1, 0).bit_length()
    out = np.zeros((B, rows, C), np.float32)
    for b in range(B):
        if mode == "devoxelize":
            table = corners(inputs["coords"][b:b + 1], R)
            dest = np.concatenate([t[0][0] for t in table])
        else:
            dest = inputs["idx"][b].reshape(-1)
        keys = np.sort(dest.astype(np.int64) << ebits | np.arange(E))
        assert keys.max() < 2 ** 31 - 1  # INT_MAX pads the sort
        order = keys & ((1 << ebits) - 1)
        start = np.searchsorted(keys, np.arange(rows + 1) << ebits)
        for v in range(rows):
            acc = np.zeros(C, np.float32)
            for e in order[start[v]:start[v + 1]]:
                if mode == "ball_query_group":
                    term = g[b, e]
                elif mode == "three_nn_interpolate":
                    term = inputs["weights"][b].reshape(-1)[e] * g[b, e // 3]
                else:
                    c, n = divmod(int(e), S)
                    _, wx, wy, wz = (t[0, n] for t in table[c])
                    term = (wx * wy) * (wz * g[b, n])
                acc = (acc + term).astype(np.float32)
            out[b, v] = acc
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
    entries a cloud; the rooms models: 32,768) and refuses more entries or
    rows than one block's sort holds, or more clouds than the grid takes."""
    calls = backward_calls(config)
    assert max(E for _, _, E, _, _ in calls) == (16384 if config == "PVDS_PUNet.yaml" else 32768)
    for call in calls:
        scatter.check_scatter_shape(*call)
    for B, S, E, rows, C in ((1, 4097, 8 * 4097, 64, 32), (1, 64, 64, 2 ** 15 + 1, 32),
                             (2 ** 16, 64, 64, 64, 32), (1, 64, 0, 64, 32),
                             (1, 2 ** 16, 2 ** 15, 64, 2 ** 15)):
        with pytest.raises(ValueError, match="scatter_rows kernel takes"):
            scatter.check_scatter_shape(B, S, E, rows, C)
