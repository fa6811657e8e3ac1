"""Kernel K4's set-abstraction entry, ``ball_query_group_rel``, on the CPU.

The fused entry writes the SA module's grouped tensor ``[p - centre |
features]`` in the features' dtype, so it must equal the module's
composition (``cat`` of coordinates and features, ball query + gather,
subtract the centre, ``cat``) bit for bit: here against the JAX package's
composition (``p2p_bridge_tpu/models/pvcnn.py`` PointNetSAModule) and the
port's, in f32 and bf16, with a centre that has no hit and centres with
fewer hits than K; its gradients against the composition's; a model of the
kernel's scan and flat stream (spans of positions walking (slot, column))
against the plain version; and the kernel's shape check against every SA
call of the shipped configs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p2p_bridge_tpu.ops as jops
from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.ops import ball_query as bq


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """CPU tensors take the plain versions: no kernel is launched."""
    before = dict(kernels.launch_counts)
    yield
    assert kernels.launch_counts == before


def inputs(B, N, M, C, seed):
    """Points in the unit cube, centres among them except centre 0 of cloud
    0, which lies far from every point (no hit), and features."""
    rng = np.random.default_rng(seed)
    pts = rng.random((B, N, 3)).astype(np.float32)
    cen = np.take_along_axis(pts, rng.integers(0, N, (B, M))[..., None], axis=1).copy()
    cen[0, 0] = 5.0
    feat = rng.normal(size=(B, N, C)).astype(np.float32)
    return cen, pts, feat


# (B, N, M, K, C, radius): few hits (K past the hit count), many hits (the
# scan stops early), the main path's K = 32 with 32 features (rows of 35),
# N not a multiple of 4 or 128, and K > N
CASES = [(2, 100, 16, 8, 5, 0.2), (2, 300, 12, 16, 8, 0.6), (2, 256, 16, 32, 32, 0.25),
         (1, 131, 9, 32, 3, 0.4), (2, 6, 4, 9, 4, 0.9)]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def jax_composition(cen, pts, feat, radius, K, jdt):
    """The JAX SA module's grouping."""
    feat = jnp.asarray(feat).astype(jdt)
    aug = jnp.concatenate([jnp.asarray(pts).astype(jdt), feat], axis=-1)
    both, idx = jops.ball_query_group(jnp.asarray(cen), jnp.asarray(pts), aug, radius, K)
    rel = both[..., :3] - jnp.asarray(cen)[:, :, None, :].astype(both.dtype)
    return jnp.concatenate([rel, both[..., 3:]], axis=-1).astype(jdt), idx


def torch_composition(cen, pts, feat, radius, K):
    """The port's SA module before the fused entry: the rows entry of K4
    between plain ops."""
    rows = torch.cat([pts.to(feat.dtype), feat], dim=-1)
    both, idx = bq.ball_query_group(cen, pts, rows, radius, K)
    rel = both[..., :3] - cen[:, :, None, :].to(both.dtype)
    return torch.cat([rel, both[..., 3:]], dim=-1).to(feat.dtype), idx


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,N,M,K,C,radius", CASES)
def test_fused_grouping_matches_jax_composition(B, N, M, K, C, radius, dtype):
    tdt, jdt = DTYPES[dtype]
    cen, pts, feat = inputs(B, N, M, C, N + K)
    want_g, want_i = jax_composition(cen, pts, feat, radius, K, jdt)
    got_g, got_i = bq.ball_query_group_rel(torch.from_numpy(cen), torch.from_numpy(pts),
                                           torch.from_numpy(feat).to(tdt), radius, K)
    assert got_g.dtype == tdt and got_g.shape == (B, M, K, C + 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_g.float().numpy(), np.asarray(want_g, np.float32))
    assert (got_i[0, 0] == 0).all()  # the centre with no hit
    hits = (got_i[..., 1:] != got_i[..., :1]).sum(-1)
    assert (hits < K - 1).any()  # slots past the hit count repeat the first hit


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,N,M,K,C,radius", CASES)
def test_fused_grouping_matches_torch_composition(B, N, M, K, C, radius, dtype):
    tdt = DTYPES[dtype][0]
    cen, pts, feat = (torch.from_numpy(a) for a in inputs(B, N, M, C, N + K))
    feat = feat.to(tdt)
    got_g, got_i = bq.ball_query_group_rel(cen, pts, feat, radius, K)
    want_g, want_i = torch_composition(cen, pts, feat, radius, K)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_g, want_g)
    plain_g, plain_i = bq.ball_query_group_rel_plain(cen, pts, feat, radius, K)
    assert torch.equal(plain_g, got_g) and torch.equal(plain_i, got_i)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("coords_grad", [False, True])
def test_fused_grouping_gradients_match_the_composition(dtype, coords_grad):
    """The features' gradient (the scatter of grad[..., 3:]) is bit-equal to
    the composition's; where the coordinates and centres ask for one, they
    get the composition's too (+ the scatter of grad[..., :3] into the
    points, - its sum over the neighbours into the centres), and none
    otherwise."""
    tdt = DTYPES[dtype][0]
    B, N, M, K, C, radius = 2, 120, 16, 8, 6, 0.3
    cen, pts, feat = (torch.from_numpy(a) for a in inputs(B, N, M, C, 3))
    feat = feat.to(tdt)
    g = torch.randn(B, M, K, C + 3, generator=torch.Generator().manual_seed(1)).to(tdt)
    grads = []
    for fn in (bq.ball_query_group_rel, torch_composition):
        c, p, f = (x.clone().requires_grad_(x is feat or coords_grad) for x in (cen, pts, feat))
        fn(c, p, f, radius, K)[0].backward(g)
        grads.append((c.grad, p.grad, f.grad))
    (gc, gp, gf), (wc, wp, wf) = grads
    assert gf.dtype == tdt and torch.equal(gf, wf)
    if coords_grad:
        assert gc.dtype == gp.dtype == torch.float32
        assert torch.equal(gp, wp) and torch.equal(gc, wc)
        assert gp.abs().sum() > 0 and gc.abs().sum() > 0
    else:
        assert gc is None and gp is None


def test_the_module_records_no_graph_without_gradients():
    cen, pts, feat = (torch.from_numpy(a) for a in inputs(1, 50, 4, 3, 0))
    grouped, _ = bq.ball_query_group_rel(cen, pts, feat.requires_grad_(), 0.3, 4)
    assert grouped.grad_fn is not None
    with torch.no_grad():
        grouped, _ = bq.ball_query_group_rel(cen, pts, feat, 0.3, 4)
    assert grouped.grad_fn is None


# ------------------------------------------------------- the kernel's walk
CENTRES = 64  # csrc/ball_query_group.cu kCentres: centres a block


def kernel_model(cen, pts, feat, radius, K, vec):
    """K4's _rel entry as csrc/ball_query_group.cu computes it: each centre
    tests the points in index order in f32 without FMA and appends its hits
    until it has K; slots past the hits repeat the first (index 0 without
    a hit). A block's 64 centres own K * W contiguous output positions; a
    warp reads a span of 32 * vec of them lane by lane, lane l at position
    j0 + 32 u + l for u < vec, stepping from (slot, column) to the next by
    32 // W slots and 32 % W columns with one carry, and reading the block's
    last slot past the end. Elements are f32 here (the bf16 rounding is the
    plain version's)."""
    B, M, _ = cen.shape
    N, C = pts.shape[1], feat.shape[-1]
    W = C + 3
    r2 = np.float32(bq._radius_sq(radius))
    out = np.zeros((B, M * K * W), np.float32)
    idx = np.zeros((B, M, K), np.int32)
    dr, dc = divmod(32, W)
    for b in range(B):
        for m in range(M):
            slot = []
            for i in range(N):
                d = cen[b, m] - pts[b, i]
                if (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] < r2 and len(slot) < K:
                    slot.append(i)
            idx[b, m] = slot + [slot[0] if slot else 0] * (K - len(slot))
        for m0 in range(0, M, CENTRES):
            nc = min(CENTRES, M - m0)
            slots = idx[b, m0:m0 + nc].reshape(-1)
            L = nc * K * W
            block = np.zeros(L + 32 * vec, np.float32)
            for j0 in range(0, L, 32 * vec):
                for lane in range(32):
                    r, c = divmod(j0 + lane, W)
                    for u in range(vec):
                        row = slots[min(r, nc * K - 1)]
                        m = m0 + min(r, nc * K - 1) // K
                        block[j0 + 32 * u + lane] = (pts[b, row, c] - cen[b, m, c] if c < 3
                                                     else feat[b, row, c - 3])
                        c, r = c + dc, r + dr
                        if c >= W:
                            c, r = c - W, r + 1
            out[b, m0 * K * W:(m0 + nc) * K * W] = block[:L]
    return out.reshape(B, M, K, W), idx


@pytest.mark.parametrize("B,N,M,K,C,radius", CASES[:4] + [(1, 70, 130, 4, 3, 0.3)])
def test_kernel_walk_matches_the_plain_version(B, N, M, K, C, radius):
    """Spans of 16-byte vectors of f32 (4) and bf16 (8), at rows wider and
    narrower than 32 columns (W = 6), and over more than one block of
    centres (M = 130)."""
    cen, pts, feat = inputs(B, N, M, C, N + K)
    want_g, want_i = bq.ball_query_group_rel_plain(
        torch.from_numpy(cen), torch.from_numpy(pts), torch.from_numpy(feat), radius, K)
    for vec in (4, 8):
        got_g, got_i = kernel_model(cen, pts, feat, radius, K, vec)
        np.testing.assert_array_equal(got_i, want_i.numpy())
        np.testing.assert_array_equal(got_g, want_g.numpy())


@pytest.mark.parametrize("config", ["PVDS_PUNet.yaml", "PVDL_SNPP.yaml"])
def test_ball_query_kernel_takes_every_config_call(config):
    """K4's shape check passes every SA call of the shipped configs at their
    training batch and at 73 patches, and refuses what it cannot hold."""
    from pathlib import Path

    from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config
    from p2p_bridge_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(str(Path(__file__).resolve().parent.parent / "configs" / config))
    with torch.device("meta"):
        plan = build_unet_from_config(cfg).plan
    for stage in plan.sa_stages:
        for B in (cfg["training"]["bs"], 73):
            bq.check_ball_query_shape(B, stage.sa.num_neighbors, stage.sa.in_channels + 3)
    for B, K, W in ((0, 32, 35), (2 ** 16, 32, 35), (1, bq.MAX_NEIGHBORS + 1, 35), (1, 0, 35),
                    (1, 128, 2 ** 18)):
        with pytest.raises(ValueError, match="ball_query_group kernel takes"):
            bq.check_ball_query_shape(B, K, W)
