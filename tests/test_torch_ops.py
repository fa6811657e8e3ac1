"""The port's point ops against the JAX package's, on the CPU.

Each op of the port runs its plain PyTorch version here (CPU tensors); the
JAX side runs its XLA path and, for the ops with a TPU kernel, the Pallas
kernel in interpret mode as tests/test_pallas_kernels.py runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import p2p_bridge_tpu.ops as jops
import p2p_bridge_tpu.ops.interpolate as jinterp
import p2p_bridge_tpu.ops.pallas.fps_kernel as jfps_kernel
import p2p_bridge_tpu.ops.pallas.neighborhood_kernel as jnbr_kernel
from p2p_bridge_tpu.ops.common import pairwise_sqdist_exact as jax_sqdist_exact
from p2p_bridge_tpu.ops.fps import _furthest_point_sample_xla
from p2p_bridge_tpu.ops.pallas.devox_kernel import trilinear_devoxelize_pallas
from p2p_bridge_tpu.ops.pallas.interp_kernel import three_nn_interpolate_pallas
from p2p_bridge_tpu.ops.pallas.voxelize_kernel import avg_voxelize_scatter_pallas
from p2p_bridge_tpu_torch import kernels, ops
from p2p_bridge_tpu_torch.ops import ball_query as bq
from p2p_bridge_tpu_torch.ops import voxelize as vox
from p2p_bridge_tpu_torch.ops.interpolate import three_nn_interpolate

# bf16 keeps 8 significant bits: one rounding moves a value by at most
# 2^-9 of itself, and two roundings of nearly equal f32 values land at
# most one bf16 ulp apart, which is 2^-7 of the value at the bottom of a
# binade
BF16_ULP = 2.0 ** -7


def t(a):
    return torch.from_numpy(np.asarray(a))


def bf16_pair(a):
    """numpy f32 -> (torch bf16, jax bf16) holding the same values."""
    tb = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return tb, jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16)


def f32(x):
    """torch or jax array -> numpy f32."""
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the FPS and neighbourhood Pallas kernels in interpret mode."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfps_kernel.pl, "pallas_call", patched)
    monkeypatch.setattr(jnbr_kernel.pl, "pallas_call", patched)


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """CPU tensors take the plain versions: no kernel is launched."""
    before = dict(kernels.launch_counts)
    yield
    assert kernels.launch_counts == before


def test_pairwise_and_take_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 40, 3)).astype(np.float32)
    b = rng.normal(size=(2, 70, 3)).astype(np.float32)
    np.testing.assert_allclose(ops.pairwise_sqdist(t(a), t(b)).numpy(),
                               np.asarray(jops.pairwise_sqdist(a, b)), atol=1e-6)
    from p2p_bridge_tpu.ops.common import pairwise_sqdist_exact
    np.testing.assert_array_equal(ops.pairwise_sqdist_exact(t(a), t(b)).numpy(),
                                  np.asarray(pairwise_sqdist_exact(a, b)))
    idx = rng.integers(0, 70, size=(2, 5, 4)).astype(np.int32)
    np.testing.assert_array_equal(ops.batched_take(t(b), t(idx)).numpy(),
                                  np.asarray(jops.batched_take(jnp.asarray(b), jnp.asarray(idx))))


# clouds of integer points on a 7^3 lattice, each point repeated: exact ties
# (equal distances, duplicated points, all-zero distances once every lattice
# point is taken), at N not a multiple of 16, one above the card's cluster
# threshold
FPS_TIES = {(2, 1003, 400), (3, 517, 517), (1, 16389, 200)}


@pytest.mark.parametrize("B,N,M", [(2, 200, 48), (1, 131, 131), (9, 300, 96), (1, 2048, 64),
                                   *sorted(FPS_TIES)])
def test_fps_matches_xla(B, N, M):
    rng = np.random.default_rng(N)
    if (B, N, M) in FPS_TIES:
        x = rng.integers(-3, 4, size=(B, N, 3)).astype(np.float32)
    else:
        x = rng.normal(size=(B, N, 3)).astype(np.float32)
    want = np.asarray(_furthest_point_sample_xla(jnp.asarray(x), M))
    got = ops.furthest_point_sample(t(x), M)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,N,M", [(2, 200, 48), (9, 300, 96)])
def test_fps_matches_pallas_interpret(interpret_pallas, B, N, M):
    x = np.random.default_rng(B).normal(size=(B, N, 3)).astype(np.float32)
    want = np.asarray(jfps_kernel.furthest_point_sample_pallas(jnp.asarray(x), M))
    np.testing.assert_array_equal(ops.furthest_point_sample(t(x), M).numpy(), want)


BQ_CASES = [
    (2, 300, 64, 32, 35, 0.2),
    (2, 150, 32, 16, 131, 0.4),
    (1, 40, 8, 32, 7, 0.9),     # K > hits: pad with the first hit
    (1, 64, 8, 8, 5, 0.01),     # mostly empty balls: index 0
    (1, 20, 4, 32, 4, 2.0),     # K > N
]


def bq_inputs(B, N, M, C):
    rng = np.random.default_rng(N + M)
    pts = rng.random((B, N, 3)).astype(np.float32)
    sel = rng.integers(0, N, (B, M))
    cen = np.take_along_axis(pts, sel[..., None], axis=1)
    rows = rng.normal(size=(B, N, C)).astype(np.float32)
    return cen, pts, rows


@pytest.mark.parametrize("B,N,M,K,C,r", BQ_CASES)
def test_ball_query_group_matches_xla(B, N, M, K, C, r):
    cen, pts, rows = bq_inputs(B, N, M, C)
    want_g, want_i = jops.ball_query_group(jnp.asarray(cen), jnp.asarray(pts),
                                           jnp.asarray(rows), r, K)
    got_g, got_i = ops.ball_query_group(t(cen), t(pts), t(rows), r, K)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(bq.ball_query(t(cen), t(pts), r, K).numpy(),
                                  np.asarray(jops.ball_query(cen, pts, r, K)))


@pytest.mark.parametrize("B,N,M,K,C,r", BQ_CASES[:4])
def test_ball_query_group_matches_pallas_interpret(interpret_pallas, B, N, M, K, C, r):
    cen, pts, rows = bq_inputs(B, N, M, C)
    want_g, want_i = jnbr_kernel.ball_query_group_pallas(
        jnp.asarray(cen), jnp.asarray(pts), jnp.asarray(rows), r, K)
    got_g, got_i = ops.ball_query_group(t(cen), t(pts), t(rows), r, K)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # the Pallas gather rides a bf16 hi/lo split: ~1e-5 relative
    scale = np.abs(rows).max()
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-5 * scale)


@pytest.mark.parametrize("r,C,hi", [(8, 11, 8), (8, 11, 2), (4, 128, 4)])
def test_voxelize_matches_jax(r, C, hi):
    """Against the exact scatter and the Pallas scatter kernel (interpret),
    for uniform and collision-heavy voxel indices."""
    rng = np.random.default_rng(r * C)
    B, N = 2, 300
    feat = rng.normal(size=(B, N, C)).astype(np.float32)
    voxc = rng.integers(0, hi, size=(B, N, 3)).astype(np.int32)
    got = ops.avg_voxelize(t(feat), t(voxc), r).numpy()
    want = np.asarray(jops.avg_voxelize(jnp.asarray(feat), jnp.asarray(voxc), r, exact=True))
    np.testing.assert_allclose(got, want, atol=1e-6)
    idx = jops.flat_voxel_index(jnp.asarray(voxc), r)
    kern = np.asarray(avg_voxelize_scatter_pallas(jnp.asarray(feat), idx, r ** 3, interpret=True))
    np.testing.assert_allclose(got.reshape(B, r ** 3, C), kern, atol=1e-6)


@pytest.mark.parametrize("r", [4, 8, 32])
def test_normalize_coords_to_voxels_matches_jax(r):
    x = np.random.default_rng(5).normal(size=(2, 500, 3)).astype(np.float32) * 0.4
    wv, wc = jops.normalize_coords_to_voxels(jnp.asarray(x), r)
    gv, gc = vox.normalize_coords_to_voxels(t(x), r)
    assert gv.dtype == torch.int32
    # the centroid and the max norm sum 500 points in another order than
    # XLA: measured 1.6e-6 relative on coords up to r - 1 = 31
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=4e-6, atol=1e-6)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def devox_inputs(r=8, C=16, N=200):
    rng = np.random.default_rng(r)
    grid = rng.normal(size=(2, r, r, r, C)).astype(np.float32)
    coords = rng.uniform(0, r - 1, size=(2, N, 3)).astype(np.float32)
    coords[:, 0] = 0.0            # frac == 0 at the low edge
    coords[:, 1] = r - 1.0        # the r-1 corner: no high step
    coords[:, 2] = [3.0, 2.0, 5.0]
    coords[:, 3] = [r - 1.0, 0.5, 2.0]
    return grid, coords


def test_devoxelize_matches_jax():
    grid, coords = devox_inputs()
    want = np.asarray(jops.trilinear_devoxelize(jnp.asarray(grid), jnp.asarray(coords), 8))
    got = ops.trilinear_devoxelize(t(grid), t(coords), 8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    wo, wm = jops.trilinear_devoxelize_with_mean(jnp.asarray(grid), jnp.asarray(coords), 8)
    go, gm = ops.trilinear_devoxelize_with_mean(t(grid), t(coords), 8)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=1e-6)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-6)


@pytest.mark.parametrize("r,C", [(8, 40), (16, 16)])
def test_devoxelize_bf16_matches_pallas_interpret(r, C):
    """K3's plain version on a bf16 grid against the Pallas kernel. The
    Pallas kernel rounds the xy corner weights to bf16 (2^-9 relative
    each; the 8 weights sum to 1, so at most 2^-9 max|grid|) and both
    round the output to bf16 (at most one ulp apart, 2^-7 max|grid|):
    tolerance 2^-6 max|grid|. The mean is f32 of the same bf16 values."""
    grid, coords = devox_inputs(r=r, C=C)
    tg, jg = bf16_pair(grid)
    want_o, want_m = trilinear_devoxelize_pallas(jg, jnp.asarray(coords), r,
                                                 interpret=True, with_mean=True)
    got_o, got_m = ops.trilinear_devoxelize_with_mean(tg, t(coords), r)
    assert got_o.dtype == torch.bfloat16 and got_m.dtype == torch.float32
    scale = np.abs(f32(tg)).max()
    np.testing.assert_allclose(f32(got_o), f32(want_o), atol=2 * BF16_ULP * scale)
    np.testing.assert_allclose(got_m.numpy(), f32(want_m), atol=1e-6)
    # the same bf16 values in f32: the algorithm, tightly
    want32 = np.asarray(jops.trilinear_devoxelize(jnp.asarray(f32(tg)), jnp.asarray(coords), r))
    np.testing.assert_allclose(f32(ops.trilinear_devoxelize(tg.float(), t(coords), r)),
                               want32, atol=1e-6)


def nn_inputs(M, N=150, C=9, seed=None):
    rng = np.random.default_rng(M if seed is None else seed)
    pts = rng.random((2, N, 3)).astype(np.float32)
    cen = rng.random((2, M, 3)).astype(np.float32)
    feat = rng.normal(size=(2, M, C)).astype(np.float32)
    return pts, cen, feat


@pytest.mark.parametrize("M", [1, 2, 3, 64])
def test_three_nn_interpolate_matches_jax(M, monkeypatch):
    """The port ranks centres by per-coordinate squared distances (the
    kernels' arithmetic). Against the XLA path with the same distances
    (pairwise_sqdist_exact): indices equal, weights and output at 1e-6.
    Against the XLA path as it ships (|a|^2 + |b|^2 - 2ab, which cancels
    at small distances): the same indices."""
    pts, cen, feat = nn_inputs(M)
    _, wi = jops.three_nn(jnp.asarray(pts), jnp.asarray(cen))
    gw, gi = ops.three_nn(t(pts), t(cen))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    monkeypatch.setattr(jinterp, "pairwise_sqdist", jax_sqdist_exact)
    ww, wi = jops.three_nn(jnp.asarray(pts), jnp.asarray(cen))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), atol=1e-6)
    want = jops.nearest_neighbor_interpolate(jnp.asarray(pts), jnp.asarray(cen), jnp.asarray(feat))
    got = ops.nearest_neighbor_interpolate(t(pts), t(cen), t(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("M,dtype", [(3, "f32"), (64, "f32"), (64, "bf16"), (200, "bf16")])
def test_three_nn_interpolate_matches_pallas_interpret(M, dtype):
    """K6's plain version against the Pallas kernel: indices equal to its
    aux lanes 3:6, weights to lanes 0:3 at 1e-6. The Pallas kernel rounds
    the weights and the features to bf16 for its MXU product (2^-9 each,
    weights summing to 1) and the port rounds a bf16 output once more (one
    ulp, 2^-7): output tolerance 2^-6 max|features|."""
    pts, cen, feat = nn_inputs(M, N=300, C=40)
    if dtype == "bf16":
        tf, jf = bf16_pair(feat)
    else:
        tf, jf = t(feat), jnp.asarray(feat)
    want, aux = three_nn_interpolate_pallas(jnp.asarray(pts), jnp.asarray(cen), jf,
                                            interpret=True)
    got, gw, gi = three_nn_interpolate(t(pts), t(cen), tf)
    assert got.dtype == tf.dtype
    aux = np.asarray(aux)
    np.testing.assert_array_equal(gi.numpy(), aux[..., 3:6].astype(np.int32))
    np.testing.assert_allclose(gw.numpy(), aux[..., 0:3], atol=1e-6)
    scale = np.abs(f32(tf)).max()
    np.testing.assert_allclose(f32(got), f32(want), atol=2 * BF16_ULP * scale)
    # the model's form returns the same sum without weights or indices
    alone, no_w, no_i = three_nn_interpolate(t(pts), t(cen), tf, with_weights=False)
    assert no_w is None and no_i is None and torch.equal(alone, got)


def test_three_nn_ties_go_to_the_lowest_index():
    """Duplicate centres tie exactly: the lower index ranks first, as in
    the Pallas kernel's iota-min and lax.top_k."""
    pts, cen, feat = nn_inputs(16, N=64, C=8, seed=7)
    cen[:, 9] = cen[:, 2]
    cen[:, 12] = cen[:, 2]
    cen[:, 5] = cen[:, 14]
    pts[:, :4] = cen[:, 2:3] + 1e-3  # these points tie on their 3 nearest
    _, gw, gi = three_nn_interpolate(t(pts), t(cen), t(feat))
    np.testing.assert_array_equal(gi.numpy()[:, :4], [[[2, 9, 12]] * 4] * 2)
    _, aux = three_nn_interpolate_pallas(jnp.asarray(pts), jnp.asarray(cen),
                                         jnp.asarray(feat), interpret=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(aux)[..., 3:6].astype(np.int32))
    _, wi = jops.three_nn(jnp.asarray(pts), jnp.asarray(cen))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("r,C,hi", [(8, 11, 8), (4, 128, 2)])
def test_voxelize_bf16_matches_jax(r, C, hi):
    """bf16 features: an f32 sum, the mean rounded once to bf16, as the
    JAX exact path does: bit-equal but for the f32 summation order (a
    tie of that rounding at most one bf16 ulp apart)."""
    rng = np.random.default_rng(r + C)
    feat = rng.normal(size=(2, 300, C)).astype(np.float32)
    voxc = rng.integers(0, hi, size=(2, 300, 3)).astype(np.int32)
    tf, jf = bf16_pair(feat)
    got = ops.avg_voxelize(tf, t(voxc), r)
    want = jops.avg_voxelize(jf, jnp.asarray(voxc), r, exact=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), atol=BF16_ULP * np.abs(feat).max())


@pytest.mark.parametrize("B,N,M,K,C,r", BQ_CASES[:3])
def test_ball_query_group_bf16_matches_jax(B, N, M, K, C, r):
    """bf16 rows: f32 distances from f32 coordinates, the rows copied bit
    for bit, as the JAX path groups them."""
    cen, pts, rows = bq_inputs(B, N, M, C)
    tr, jr = bf16_pair(rows)
    want_g, want_i = jops.ball_query_group(jnp.asarray(cen), jnp.asarray(pts), jr, r, K)
    got_g, got_i = ops.ball_query_group(t(cen), t(pts), tr, r, K)
    assert got_g.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(f32(got_g), f32(want_g))


def test_knn_matches_jax():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(1, 6, 3)).astype(np.float32)
    p = rng.normal(size=(1, 1024, 3)).astype(np.float32)
    p[0, 700] = p[0, 3]  # a duplicate: equal distances stay in index order
    wd, wi = jops.knn(jnp.asarray(q), jnp.asarray(p), 256)
    gd, gi = ops.knn(t(q), t(p), 256)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-6)


def test_require_rejects_bad_tensors():
    """kernels.check, the one tensor check of every wrapper: the device
    of the first tensor, each tensor's dtype (or one of DATA), shape and
    layout."""
    x = torch.zeros(2, 5, 3)
    idx = torch.zeros(2, 5, dtype=torch.int32)
    assert kernels.check(("x", x, torch.float32, (2, 5, 3)),
                         ("idx", idx, torch.int32, (2, 5))) == -1
    assert kernels.check(("x", x.bfloat16(), kernels.DATA, (2, 5, 3))) == -1
    with pytest.raises(TypeError):
        kernels.check(("x", x.double(), torch.float32, (2, 5, 3)))
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.check(("x", x.half(), kernels.DATA, (2, 5, 3)))
    with pytest.raises(ValueError, match="shape"):
        kernels.check(("x", x, torch.float32, (2, 5, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.check(("x", x.transpose(0, 1), torch.float32, (5, 2, 3)))
    with pytest.raises(ValueError, match="device"):
        kernels.check(("x", x, torch.float32, (2, 5, 3)),
                      ("idx", idx.to("meta"), torch.int32, (2, 5)))


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    assert not kernels.on_card(torch.zeros(1))
    meta = torch.zeros(1, 8, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA card or the CPU"):
        ops.furthest_point_sample(meta, 2)
    with pytest.raises(ValueError, match="CUDA card or the CPU"):
        ops.avg_voxelize(meta, meta.int(), 4)
    with pytest.raises(ValueError, match="CUDA card or the CPU"):
        ops.trilinear_devoxelize(torch.zeros(1, 2, 2, 2, 4, device="meta"), meta, 2)
    with pytest.raises(ValueError, match="CUDA card or the CPU"):
        ops.nearest_neighbor_interpolate(meta, meta, meta)
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.check(("x", torch.zeros(1, dtype=torch.float16), kernels.DATA, (1,)))


def test_library_path_follows_sources():
    """The build is keyed by the sources and flags, inside build/."""
    path = kernels.library_path()
    assert path == kernels.library_path()
    assert path.name == "libp2pb_kernels.so"
    assert path.parent.parent == kernels.BUILD_ROOT
    assert all((kernels.CSRC / s).exists() for s in kernels.SOURCES + kernels.HEADERS)


# ---------------------------------------------------------------- backward
# Each op's autograd backward (the plain branch on the CPU) against the VJP
# of the JAX op on the same inputs and cotangent.
import jax  # noqa: E402

import p2p_bridge_tpu.ops.voxelize as jvox  # noqa: E402
from p2p_bridge_tpu.ops.pallas.conv3d_kernel import _ref_conv_gn  # noqa: E402
from p2p_bridge_tpu.ops.pallas.wconv3d_kernel import wconv3d_gn_pallas  # noqa: E402
from p2p_bridge_tpu_torch.ops import conv3d_gn as conv_ops  # noqa: E402


def vjp_port(fn, inputs, cotangent, wrt):
    """Gradients of sum(fn(*inputs) * cotangent) for the inputs at ``wrt``."""
    leaves = [x.clone().requires_grad_(i in wrt) for i, x in enumerate(inputs)]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cts = cotangent if isinstance(cotangent, tuple) else (cotangent,)
    loss = sum((o.float() * c.float()).sum() for o, c in zip(outs, cts) if c is not None)
    loss.backward()
    return [leaves[i].grad for i in wrt]


def vox_backward_inputs(r, C, hi, seed=0):
    """Features, voxel coords with empty voxels (indices below ``hi``) and
    several points per voxel, a cotangent grid."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(2, 300, C)).astype(np.float32)
    voxc = rng.integers(0, hi, size=(2, 300, 3)).astype(np.int32)
    g = rng.normal(size=(2, r, r, r, C)).astype(np.float32)
    return feat, voxc, g


@pytest.mark.parametrize("r,C,hi", [(8, 11, 8), (8, 32, 3), (4, 128, 4)])
def test_voxelize_backward_is_bit_equal_to_jax_grad(r, C, hi):
    """K2b's plain version through autograd, f32: the gradient of the JAX
    exact path (g / count gathered back to each point), bit for bit."""
    feat, voxc, g = vox_backward_inputs(r, C, hi)
    _, pull = jax.vjp(lambda f: jops.avg_voxelize(f, jnp.asarray(voxc), r, exact=True),
                      jnp.asarray(feat))
    want = np.asarray(pull(jnp.asarray(g))[0])
    (got,) = vjp_port(lambda f: ops.avg_voxelize(f, t(voxc), r), [t(feat)], t(g), [0])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("r,C,hi", [(8, 16, 8), (4, 64, 2)])
def test_voxelize_backward_matches_gather_rows_pallas(r, C, hi, dtype):
    """Against ``_avp_bwd``: the counts from its one-hot product, the rows
    from ``gather_rows_pallas`` in interpret mode, one f32 divide and one
    rounding to the features' dtype: bit-equal in f32 and in bf16."""
    feat, voxc, g = vox_backward_inputs(r, C, hi, seed=r + C)
    B, N = feat.shape[:2]
    tg, jg = (t(g), jnp.asarray(g)) if dtype == "f32" else bf16_pair(g)
    idx = jops.flat_voxel_index(jnp.asarray(voxc), r)
    proto = jnp.zeros((0,), jg.dtype)
    want = jvox._avp_bwd(r ** 3, (idx, proto), jg.reshape(B, r ** 3, C))[0]
    tidx = vox.flat_voxel_index(t(voxc), r).int()
    cnt = torch.zeros(B, r ** 3).scatter_add_(1, tidx.long(), torch.ones(B, N))
    got = vox.avg_voxelize_backward(tg.reshape(B, r ** 3, C), tidx, cnt)
    assert got.dtype == tg.dtype
    np.testing.assert_array_equal(f32(got), f32(want))
    # through autograd, the counts kept from the forward
    tf = t(feat) if dtype == "f32" else bf16_pair(feat)[0]
    (auto,) = vjp_port(lambda f: ops.avg_voxelize(f, t(voxc), r), [tf], tg, [0])
    assert torch.equal(auto, got)


def conv_backward_inputs(B, R, cin, cout, per_cloud, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, R, R, R, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    shape = (B, cout) if per_cloud else (cout,)
    gamma = (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    beta = (0.1 * rng.normal(size=shape)).astype(np.float32)
    g = rng.normal(size=(B, R, R, R, cout)).astype(np.float32)
    return [x, w, b, gamma, beta], g


# f32 convolution transposes sum up to 27 * Cin * R^3 products in another
# order than XLA: measured up to 2.4e-6 of each gradient's largest entry
CONV_GRAD_TOL = 2e-5


@pytest.mark.parametrize("per_cloud", [False, True], ids=["shared_affine", "adagn_affine"])
@pytest.mark.parametrize("act", [True, False])
def test_conv3d_gn_backward_matches_jax_vjp(act, per_cloud):
    """K1's backward (the recomputed conv + GroupNorm) against jax.vjp of
    the JAX package's fused entry point, whose custom VJP differentiates
    the XLA composition; the per-cloud [B, C] affine is the AdaGN fold."""
    inputs, g = conv_backward_inputs(2, 16, 64, 64, per_cloud)
    fn = lambda *a: wconv3d_gn_pallas(*a, groups=8, eps=1e-5, act=act, interpret=True)  # noqa: E731
    _, pull = jax.vjp(fn, *map(jnp.asarray, inputs))
    want = pull(jnp.asarray(g))
    got = vjp_port(lambda *a: conv_ops.conv3d_gn(*a, groups=8, eps=1e-5, act=act),
                   [t(a) for a in inputs], t(g), range(5))
    for name, gv, wv in zip(("x", "weight", "bias", "gamma", "beta"), got, want):
        wv = np.asarray(wv)
        assert gv.shape == wv.shape, name
        np.testing.assert_allclose(gv.numpy(), wv, atol=CONV_GRAD_TOL * np.abs(wv).max(),
                                   err_msg=name)


def test_conv3d_gn_backward_ragged_channels_matches_jax_vjp():
    """A ragged Cin (the first PVConv's 35 channels) and Cout = 16, against
    jax.vjp of the composition the JAX package differentiates for them."""
    inputs, g = conv_backward_inputs(2, 4, 35, 16, True, seed=3)
    fn = lambda *a: _ref_conv_gn(*a, groups=8, eps=1e-5, act=True)  # noqa: E731
    _, pull = jax.vjp(fn, *map(jnp.asarray, inputs))
    want = pull(jnp.asarray(g))
    got = vjp_port(lambda *a: conv_ops.conv3d_gn(*a, groups=8, eps=1e-5, act=True),
                   [t(a) for a in inputs], t(g), range(5))
    for name, gv, wv in zip(("x", "weight", "bias", "gamma", "beta"), got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(gv.numpy(), wv, atol=CONV_GRAD_TOL * np.abs(wv).max(),
                                   err_msg=name)


@pytest.mark.parametrize("with_mean", [False, True])
def test_devoxelize_backward_matches_jax_vjp(with_mean):
    """K3's backward: the weighted 8-corner scatter (and g_mean / r^3 with
    the mean) against jax.vjp of the JAX op; f32 sums of up to 8 * N terms
    per voxel in another order: 1e-6 of the largest entry."""
    r = 8
    grid, coords = devox_inputs(r=r, C=16)
    rng = np.random.default_rng(9)
    g = rng.normal(size=coords.shape[:2] + (16,)).astype(np.float32)
    gm = rng.normal(size=(2, 16)).astype(np.float32)
    if with_mean:
        fn, ct, tct = jops.trilinear_devoxelize_with_mean, (jnp.asarray(g), jnp.asarray(gm)), \
            (t(g), t(gm))
        port = ops.trilinear_devoxelize_with_mean
    else:
        fn, ct, tct = jops.trilinear_devoxelize, jnp.asarray(g), t(g)
        port = ops.trilinear_devoxelize
    _, pull = jax.vjp(lambda x: fn(x, jnp.asarray(coords), r), jnp.asarray(grid))
    want = np.asarray(pull(ct)[0])
    (got,) = vjp_port(lambda x: port(x, t(coords), r), [t(grid)], tct, [0])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("B,N,M,K,C,r", BQ_CASES[:4])
def test_ball_query_group_backward_matches_jax_vjp(B, N, M, K, C, r):
    """K4's backward: each gathered row's gradient added into its source
    row (repeated indices add up); no gradient to centres or points."""
    cen, pts, rows = bq_inputs(B, N, M, C)
    g = np.random.default_rng(C).normal(size=(B, M, K, C)).astype(np.float32)
    _, pull = jax.vjp(lambda a: jops.ball_query_group(jnp.asarray(cen), jnp.asarray(pts),
                                                      a, r, K)[0], jnp.asarray(rows))
    want = np.asarray(pull(jnp.asarray(g))[0])
    got = vjp_port(lambda c, p, a: ops.ball_query_group(c, p, a, r, K)[0],
                   [t(cen), t(pts), t(rows)], t(g), [0, 1, 2])
    assert got[0] is None and got[1] is None
    np.testing.assert_allclose(got[2].numpy(), want, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("M", [2, 3, 64])
def test_three_nn_interpolate_backward_matches_jax_vjp(M, monkeypatch):
    """K6's backward: W^T g into the three centres of each point; the
    weights are stop-gradient, so points and centres get none. The JAX
    side ranks and weighs with the port's per-coordinate distances, as in
    the forward test above."""
    monkeypatch.setattr(jinterp, "pairwise_sqdist", jax_sqdist_exact)
    pts, cen, feat = nn_inputs(M)
    g = np.random.default_rng(M + 1).normal(size=(2, pts.shape[1], feat.shape[-1]))
    g = g.astype(np.float32)
    _, pull = jax.vjp(jops.nearest_neighbor_interpolate, *map(jnp.asarray, (pts, cen, feat)))
    want = [np.asarray(w) for w in pull(jnp.asarray(g))]
    got = vjp_port(ops.nearest_neighbor_interpolate, [t(pts), t(cen), t(feat)], t(g), [0, 1, 2])
    assert got[0] is None and got[1] is None
    assert not want[0].any() and not want[1].any()
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-6 * np.abs(want[2]).max())


def test_kernel_ops_carry_a_grad_fn_on_the_cpu():
    """Every kernel op's output joins the autograd graph through its
    Function, whose forward is the one that launches the kernel on a
    CUDA tensor."""
    feat, voxc, _ = vox_backward_inputs(4, 8, 4)
    f = t(feat).requires_grad_()
    names = {
        "avg_voxelize": ops.avg_voxelize(f, t(voxc), 4),
        "conv3d_gn": conv_ops.conv3d_gn(torch.zeros(1, 4, 4, 4, 8, requires_grad=True),
                                        torch.zeros(3, 3, 3, 8, 8), torch.zeros(8),
                                        torch.ones(8), torch.zeros(8)),
        "trilinear_devoxelize": ops.trilinear_devoxelize(
            torch.zeros(2, 4, 4, 4, 8, requires_grad=True), torch.rand(2, 300, 3) * 3, 4),
        "trilinear_devoxelize_with_mean": ops.trilinear_devoxelize_with_mean(
            torch.zeros(2, 4, 4, 4, 8, requires_grad=True), torch.rand(2, 300, 3) * 3, 4)[0],
        "ball_query_group": ops.ball_query_group(t(feat[..., :3]), t(feat[..., :3]), f, 0.5, 4)[0],
        "nearest_neighbor_interpolate": ops.nearest_neighbor_interpolate(
            t(feat[..., :3]), t(feat[:, :10, :3]), f[:, :10]),
    }
    for name, out in names.items():
        assert out.grad_fn is not None and "Backward" in type(out.grad_fn).__name__, name
