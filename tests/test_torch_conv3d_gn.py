"""conv3d_gn of the port against the JAX package's conv + GroupNorm.

The port's CPU path (the plain version of kernel K1) is held against the
XLA composition (_ref_conv + _apply_gn_xla) and against the windowed Pallas
kernel wconv3d_gn_pallas in interpret mode, in f32 and in bf16; the bf16
path also against kstack_conv3d_gn_pallas, the bf16 staging of the
pre-norm grid exactly, the channel padding the bf16 kernel's wrapper
applies, and the shapes the bf16 kernel takes.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_bridge_tpu.ops.pallas import wconv3d_kernel
from p2p_bridge_tpu.ops.pallas.conv3d_kernel import _apply_gn_xla, _ref_conv, _ref_conv_gn
from p2p_bridge_tpu.ops.pallas.conv3d_kernel import kstack_conv3d_gn_pallas
from p2p_bridge_tpu.ops.pallas.conv3d_kernel import supports as kstack_supports
from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config
from p2p_bridge_tpu_torch.ops.conv3d_gn import (CIN_MULTIPLE, check_tile_shape, conv3d_gn,
                                                conv3d_gn_plain, conv3d_gn_reference,
                                                kernel_operands)
from p2p_bridge_tpu_torch.ops.group_norm import (group_moments, group_norm_act_plain,
                                                 group_normalise)
from p2p_bridge_tpu_torch.utils.config import load_yaml

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def inputs(B, R, cin, cout, percloud, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, R, R, R, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.05).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    shape = (B, cout) if percloud else (cout,)
    gamma = (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    beta = (0.1 * rng.normal(size=shape)).astype(np.float32)
    return x, k, b, gamma, beta


def port(x, k, b, gamma, beta, act):
    before = dict(kernels.launch_counts)
    out = conv3d_gn(*(torch.from_numpy(a) for a in (x, k, b, gamma, beta)),
                    groups=8, eps=1e-5, act=act).numpy()
    assert kernels.launch_counts == before  # CPU tensors: plain version
    return out


@pytest.mark.parametrize("R,cin,cout", [(8, 35, 32), (4, 192, 128), (16, 64, 64)])
@pytest.mark.parametrize("percloud,act", [(False, False), (True, True)])
def test_conv3d_gn_matches_xla(R, cin, cout, percloud, act):
    x, k, b, gamma, beta = inputs(2, R, cin, cout, percloud)
    want = np.asarray(_ref_conv_gn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                   jnp.asarray(gamma), jnp.asarray(beta), groups=8,
                                   eps=1e-5, act=act))
    got = port(x, k, b, gamma, beta, act)
    assert got.shape == (2, R, R, R, cout)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("percloud,act", [(False, False), (True, True)])
def test_conv3d_gn_matches_wconv_pallas(percloud, act):
    x, k, b, gamma, beta = inputs(2, 16, 64, 64, percloud, seed=1)
    want = np.asarray(wconv3d_kernel.wconv3d_gn_pallas(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), jnp.asarray(gamma),
        jnp.asarray(beta), groups=8, act=act, interpret=True))
    got = port(x, k, b, gamma, beta, act)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("shape", [(2, 4, 4, 4, 16), (3, 50, 32), (2, 7, 5, 24)])
def test_apply_group_norm_matches_xla(shape):
    """The GroupNorm epilogue alone, the port's two halves (moments, then
    normalise + affine + swish), on any channels-last rank."""
    rng = np.random.default_rng(len(shape))
    y = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    B, C = shape[0], shape[-1]
    gamma = rng.normal(size=(B, C)).astype(np.float32)
    beta = rng.normal(size=(C,)).astype(np.float32)
    y5 = y.reshape(B, 1, 1, -1, C)
    want = np.asarray(_apply_gn_xla(jnp.asarray(y5), jnp.asarray(gamma), jnp.asarray(beta),
                                    groups=8, eps=1e-5, act=True)).reshape(shape)
    ty = torch.from_numpy(y)
    got = group_normalise(ty, group_moments(ty, 8), torch.from_numpy(gamma),
                          torch.from_numpy(beta), 1e-5, True, torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def bf16_inputs(B, R, cin, cout, percloud, seed=2):
    """inputs() with x and the kernel rounded to bf16: (torch args, jax args)."""
    x, k, b, gamma, beta = inputs(B, R, cin, cout, percloud, seed)
    tx, tk = (torch.from_numpy(a).bfloat16() for a in (x, k))
    jx, jk = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (tx, tk))
    rest = (b, gamma, beta)
    return (tx, tk, *map(torch.from_numpy, rest)), (jx, jk, *map(jnp.asarray, rest))


def port_bf16(targs, act):
    before = dict(kernels.launch_counts)
    out = conv3d_gn(*targs, groups=8, eps=1e-5, act=act)
    assert kernels.launch_counts == before  # CPU tensors: plain version
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


# Tolerance of the bf16 comparisons, times max(1, max|out|): both sides
# multiply the same bf16 values exactly and accumulate in f32, then round
# at different places. Each rounds the output at the store (2^-9 of
# |out|). One side also rounds a pre-norm value to bf16 where the other
# does not: the port stages conv + bias in bf16, as wconv3d_gn_pallas
# does; XLA's bf16 conv rounds before the bias; kstack_conv3d_gn_pallas
# normalises its f32 sum. That is an error of 2^-9 |y| that the
# normalisation scales by |gamma| / std. With these inputs |y| / std stays
# below ~3 (bias ~1, conv std ~1), so the sum is below 2^-9 * (1 + 3) ~
# 8e-3; the bound is 1e-2.
BF16_TOL = 1e-2


@pytest.mark.parametrize("percloud,act", [(False, False), (True, True)])
def test_conv3d_gn_bf16_matches_wconv_pallas(percloud, act):
    targs, jargs = bf16_inputs(2, 16, 64, 64, percloud)
    want = np.asarray(wconv3d_kernel.wconv3d_gn_pallas(
        *jargs, groups=8, act=act, interpret=True)).astype(np.float32)
    got = port_bf16(targs, act)
    assert np.abs(got - want).max() <= BF16_TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("R,cin,cout", [(8, 35, 32), (4, 192, 128)])
def test_conv3d_gn_bf16_matches_xla(R, cin, cout):
    """_apply_gn_xla(_ref_conv(...)) on bf16 x and kernel (XLA's bf16 conv,
    then the f32 bias and GroupNorm)."""
    targs, jargs = bf16_inputs(2, R, cin, cout, True)
    jx, jk, jb, jg, jbe = jargs
    want = np.asarray(_apply_gn_xla(_ref_conv(jx, jk, jb), jg, jbe, groups=8, eps=1e-5,
                                    act=True)).astype(np.float32)
    got = port_bf16(targs, True)
    assert np.abs(got - want).max() <= BF16_TOL * max(1.0, np.abs(want).max())


# The plain version stages the pre-norm conv output in x's dtype before it
# normalises it (statistics from the f32 sum), as the bf16 kernel and the
# TPU kernel do. Shapes of the first PVConv conv (r = 8 stands for 32) and
# of the widest one; no Pallas kernel of the JAX package takes Cout = 256
# (wconv3d and kstack both need 128 % Cout == 0), and wconv3d does not take
# Cin = 35 or R = 8 (wconv3d_kernel.supports), so the r = 8 35->32 shape is
# held against kstack_conv3d_gn_pallas, which computes the same function
# without the staging.
STAGED_SHAPES = [(8, 35, 32), (4, 256, 256)]


def pallas_conv_gn(jargs, R, cin, cout, act):
    """The JAX package's Pallas conv + GroupNorm in interpret mode for this
    shape, or None where neither kernel takes it."""
    if wconv3d_kernel.supports(cin, cout, R, R):
        return wconv3d_kernel.wconv3d_gn_pallas(*jargs, groups=8, act=act, interpret=True)
    if kstack_supports(cin, cout, R, R):
        return kstack_conv3d_gn_pallas(*jargs, groups=8, act=act, interpret=True)
    return None


@pytest.mark.parametrize("R,cin,cout", STAGED_SHAPES)
@pytest.mark.parametrize("percloud,act", [(False, False), (True, True)])
def test_conv3d_gn_bf16_staged_matches_jax(R, cin, cout, percloud, act):
    """Against the XLA composition and the kstack Pallas kernel, each of
    which rounds a pre-norm value where the port does not or the other way
    round: BF16_TOL. These inputs cannot tell a staged grid from an
    unstaged one (the two differ by less than BF16_TOL); the two tests
    below pin the staging."""
    targs, jargs = bf16_inputs(2, R, cin, cout, percloud, seed=R + cin)
    got = port_bf16(targs, act)
    jx, jk, jb, jg, jbe = jargs
    xla = np.asarray(_apply_gn_xla(_ref_conv(jx, jk, jb), jg, jbe, groups=8, eps=1e-5,
                                   act=act)).astype(np.float32)
    scale = max(1.0, np.abs(xla).max())
    assert np.abs(got - xla).max() <= BF16_TOL * scale
    pallas = pallas_conv_gn(jargs, R, cin, cout, act)
    if pallas is not None:
        pallas = np.asarray(pallas).astype(np.float32)
        assert np.abs(got - pallas).max() <= BF16_TOL * max(1.0, np.abs(pallas).max())


def normalise_ref(y, staged, gamma, beta, act, groups=8, eps=1e-5):
    """GroupNorm in f64 with the statistics of y and the values of staged."""
    B, C = y.shape[0], y.shape[-1]
    yg = y.astype(np.float64).reshape(B, -1, groups, C // groups)
    m = yg.mean(axis=(1, 3), keepdims=True)
    v = (yg * yg).mean(axis=(1, 3), keepdims=True) - m * m
    yn = ((staged.astype(np.float64).reshape(yg.shape) - m) / np.sqrt(v + eps)).reshape(y.shape)
    spatial = (1,) * (y.ndim - 2)
    yn = (yn * np.broadcast_to(gamma, (B, C)).reshape(B, *spatial, C)
          + np.broadcast_to(beta, (B, C)).reshape(B, *spatial, C))
    return yn / (1 + np.exp(-yn)) if act else yn


@pytest.mark.parametrize("percloud,act", [(False, False), (True, True)])
def test_apply_group_norm_normalises_the_staged_values(percloud, act):
    """K1's epilogue: the moments of the f32 y, the values normalised y
    rounded to bf16. y ~ 20 +- 1, as a grid of mostly empty voxels gives
    (y = bias there): a bf16 ulp at 20 is 0.125, so staging moves a
    normalised value by up to 0.0625 (measured 0.08 after the affine),
    while the f32 statistics, whose E[y^2] - m^2 cancels ~400 to 1, put the
    result ~1e-3 from the f64 reference (measured 9e-4); the tolerance is
    3e-3 and the unstaged result must miss by ten times that. Normalising
    y itself is group_norm_act_plain."""
    rng = np.random.default_rng(11)
    B, C = 2, 32
    y = (20 + rng.normal(size=(B, 6, 6, 6, C))).astype(np.float32)
    shape = (B, C) if percloud else (C,)
    gamma = (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    beta = (0.1 * rng.normal(size=shape)).astype(np.float32)
    ty, tg, tb = map(torch.from_numpy, (y, gamma, beta))
    moments = group_moments(ty, 8)
    got = group_normalise(ty.bfloat16(), moments, tg, tb, 1e-5, act, torch.float32).numpy()
    want = normalise_ref(y, ty.bfloat16().float().numpy(), gamma, beta, act)
    unstaged = normalise_ref(y, y, gamma, beta, act)
    assert np.abs(got - want).max() <= 3e-3
    assert np.abs(unstaged - want).max() > 3e-2  # staging shows here
    plain = group_norm_act_plain(ty, tg, tb, 8, 1e-5, act)
    assert torch.equal(group_normalise(ty, moments, tg, tb, 1e-5, act, torch.float32), plain)


@pytest.mark.parametrize("percloud,act", [(False, False), (True, True)])
def test_conv3d_gn_plain_stages_the_prenorm_grid(percloud, act):
    """conv3d_gn_plain in bf16, the version the bf16 kernel is held to on
    the card, is the f32 conv + bias normalised from its own moments with
    the values staged in bf16, bit for bit. x in {-1, 0, 1}, w in {-1, 0, 1} / 8 and a
    bias of multiples of 2^-10 near 60 make every sum exact in f32 (17
    significant bits at most), so JAX's f32 conv gives the port's y. There
    a bf16 ulp of y is 0.25 against a conv std of ~2.6, and the unstaged
    result differs in most elements."""
    rng = np.random.default_rng(12)
    B, R, cin, cout = 2, 8, 35, 32
    x = rng.integers(-1, 2, size=(B, R, R, R, cin)).astype(np.float32)
    k = (rng.integers(-1, 2, size=(3, 3, 3, cin, cout)) / 8).astype(np.float32)
    b = (60 + rng.integers(0, 1024, size=(cout,)) / 1024).astype(np.float32)
    shape = (B, cout) if percloud else (cout,)
    gamma = (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    beta = (0.1 * rng.normal(size=shape)).astype(np.float32)
    tg, tb = map(torch.from_numpy, (gamma, beta))
    tx, tk = (torch.from_numpy(a).bfloat16() for a in (x, k))
    got = conv3d_gn_plain(tx, tk, torch.from_numpy(b), tg, tb, act=act)
    y = torch.from_numpy(np.array(_ref_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))))
    want = group_normalise(y.bfloat16(), group_moments(y, 8), tg, tb, 1e-5, act, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    unstaged = group_norm_act_plain(y, tg, tb, 8, 1e-5, act, torch.bfloat16)
    assert (got != unstaged).float().mean() > 0.5


@pytest.mark.parametrize("act", [False, True])
def test_conv3d_gn_clamps_a_variance_that_rounds_below_zero(act):
    """A constant grid (zero input and weight, one bias) has variance 0, but
    for some constants E[y^2] - m^2 rounds below -eps in f32, where an
    unclamped rsqrt(var + eps) is NaN. K1's plain version and its backward's
    composition clamp it at 0, as the kernel does, and give
    group_norm_act_plain's finite output."""
    B, R, cin, cout = 2, 8, 16, 32
    x, w = torch.zeros(B, R, R, R, cin), torch.zeros(3, 3, 3, cin, cout)
    _, _, _, gamma, beta = map(torch.from_numpy, inputs(B, R, cin, cout, True))
    for c in (97.3, 100.1, 250.7, 1000.3):
        y = torch.full((B, R, R, R, cout), c)
        yg = y.reshape(B, -1, 8, cout // 8)
        m = yg.mean(dim=(1, 3), keepdim=True)
        if ((yg * yg).mean(dim=(1, 3), keepdim=True) - m * m).min() < -1e-5:
            break
    else:
        pytest.fail("no constant's f32 variance rounds below -eps")
    want = group_norm_act_plain(y, gamma, beta, 8, 1e-5, act)
    assert torch.isfinite(want).all()
    bias = torch.full((cout,), c)
    for got in (conv3d_gn_plain(x, w, bias, gamma, beta, act=act),
                conv3d_gn_reference(x, w, bias, gamma, beta, act=act)):
        assert torch.equal(got, want)


def conv_shapes(config):
    """(R, Cout) of every voxel conv of a config's backbone."""
    with torch.device("meta"):
        plan = build_unet_from_config(load_yaml(str(CONFIGS / config))).plan
    specs = [spec for stage in (*plan.sa_stages, *plan.fp_stages) for spec in stage.convs
             if spec.resolution]
    return {(spec.resolution, spec.out_channels) for spec in specs}


@pytest.mark.parametrize("config", ["PVDS_PUNet.yaml", "PVDL_SNPP.yaml", "PVDL_ARKIT.yaml"])
def test_bf16_kernel_takes_every_config_shape(config):
    """Both kernels (bf16 and f32) serve every voxel conv of the shipped
    configs (GroupNorm of 8 groups), Cout = 512 of the rooms models
    included, and the wrapper refuses what the kernels cannot tile."""
    shapes = conv_shapes(config)
    assert shapes
    for dtype in (torch.bfloat16, torch.float32):
        for R, cout in shapes:
            check_tile_shape(R, cout, 8, dtype)
        for R, cout, groups in ((24, 64, 8), (4, 64, 8), (8, 40, 8), (8, 64, 16), (8, 512, 32)):
            with pytest.raises(ValueError):
                check_tile_shape(R, cout, groups, dtype)
    check_tile_shape(64, 64, 8, torch.bfloat16)
    with pytest.raises(ValueError):  # the f32 kernel is built for R <= 32
        check_tile_shape(64, 64, 8, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin", [35, 64, 67, 192])
def test_kernel_operands_leave_the_conv_unchanged(cin, dtype):
    """What the wrapper hands each kernel: x and weight padded with zero
    channels to whole rows (35 -> 36 and 67 -> 68 in f32, 35 -> 64 and
    67 -> 96 in bf16), the f32 weight in DHWIO as it came, the bf16 weight
    as [dx, dz, dy, Cout, Cin]. Undoing the re-layout, the plain version on
    the kernel's operands is bit-equal to the plain version on the inputs
    (small integers: every sum exact in any order)."""
    rng = np.random.default_rng(cin + 1)
    x = torch.from_numpy(rng.integers(-2, 3, size=(2, 8, 8, 8, cin)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.integers(-2, 3, size=(3, 3, 3, cin, 64)).astype(np.float32) / 8).to(dtype)
    b = torch.from_numpy(rng.integers(-4, 5, size=(64,)).astype(np.float32))
    gamma, beta = torch.ones(2, 64), torch.zeros(64)
    xk, wk = kernel_operands(x, w)
    cin_k = cin + -cin % CIN_MULTIPLE[dtype]
    assert xk.dtype == wk.dtype == dtype and xk.shape[-1] == cin_k
    assert wk.is_contiguous() and xk.is_contiguous()
    if dtype == torch.bfloat16:
        assert wk.shape == (3, 3, 3, 64, cin_k)
        wk = wk.permute(0, 2, 1, 4, 3)  # back to DHWIO
    assert wk.shape == (3, 3, 3, cin_k, 64)
    assert not xk[..., cin:].any() and not wk[:, :, :, cin:].any()
    assert torch.equal(wk[:, :, :, :cin], w) and torch.equal(xk[..., :cin], x)
    want = conv3d_gn_plain(x, w, b, gamma, beta, act=True)
    assert torch.equal(conv3d_gn_plain(xk, wk, b, gamma, beta, act=True), want)


@pytest.mark.parametrize("R,cin,cout", [(8, 35, 32), (8, 67, 64)])
def test_f32_kernel_operands_match_xla(R, cin, cout):
    """The f32 kernel's operands (Cin padded to a multiple of 4) through
    the plain version agree with the JAX package's conv + GroupNorm on the
    unpadded inputs."""
    x, k, b, gamma, beta = inputs(2, R, cin, cout, True, seed=cin)
    xk, wk = kernel_operands(torch.from_numpy(x), torch.from_numpy(k))
    assert xk.shape[-1] % 4 == 0 and xk.shape[-1] > cin
    want = np.asarray(_ref_conv_gn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                   jnp.asarray(gamma), jnp.asarray(beta), groups=8,
                                   eps=1e-5, act=True))
    got = conv3d_gn_plain(xk, wk, *map(torch.from_numpy, (b, gamma, beta)), act=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("bias", [0.0, 6.0], ids=["centred", "large_mean"])
def test_bf16_bound_covers_another_summation_order(act, bias):
    """chip_smoke's per-element bound for K1 bf16 against its plain
    version holds for a stand-in of the kernel that sums the accumulator
    in another order (in f64, then rounded to f32) and takes the
    statistics from it, with groups whose |mean| is large against their
    spread (bias 6 against a conv of unit spread): the staged values of the
    two sides then differ where y crosses a bf16 rounding boundary."""
    import chip_smoke

    x, k, b, gamma, beta = inputs(2, 8, 32, 64, True, seed=3)
    x = torch.from_numpy(x).to(torch.bfloat16)
    w = (torch.from_numpy(k) * (1 / (0.05 * (27 * 32) ** 0.5))).to(torch.bfloat16)
    b = torch.from_numpy(b) * 0.1 + bias
    args = (x, w, b, torch.from_numpy(gamma), torch.from_numpy(beta))
    want = conv3d_gn_plain(*args, 8, 1e-5, act)
    y = torch.nn.functional.conv3d(x.double().permute(0, 4, 1, 2, 3),
                                   w.double().permute(4, 3, 0, 1, 2), b.double(), padding=1)
    y = y.float().permute(0, 2, 3, 4, 1)
    got = group_normalise(y.bfloat16(), group_moments(y, 8), args[3], args[4], 1e-5, act,
                          torch.bfloat16)
    diff = (got.float() - want.float()).abs()
    bound = chip_smoke.conv_bf16_bound(args, act, got, want)
    assert diff.max() > 0
    assert (diff <= bound).all(), (diff / bound).max()
