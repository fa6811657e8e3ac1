"""conv3d_gn of the port against the JAX package's conv + GroupNorm.

The port's CPU path (the plain version of kernel K1) is held against the
XLA composition (_ref_conv + _apply_gn_xla) and against the windowed Pallas
kernel wconv3d_gn_pallas in interpret mode, in f32 and in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_bridge_tpu.ops.pallas import wconv3d_kernel
from p2p_bridge_tpu.ops.pallas.conv3d_kernel import _apply_gn_xla, _ref_conv, _ref_conv_gn
from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.ops.conv3d_gn import apply_group_norm, conv3d_gn


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
    """The GroupNorm epilogue alone, on any channels-last rank."""
    rng = np.random.default_rng(len(shape))
    y = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    B, C = shape[0], shape[-1]
    gamma = rng.normal(size=(B, C)).astype(np.float32)
    beta = rng.normal(size=(C,)).astype(np.float32)
    y5 = y.reshape(B, 1, 1, -1, C)
    want = np.asarray(_apply_gn_xla(jnp.asarray(y5), jnp.asarray(gamma), jnp.asarray(beta),
                                    groups=8, eps=1e-5, act=True)).reshape(shape)
    got = apply_group_norm(torch.from_numpy(y), torch.from_numpy(gamma),
                           torch.from_numpy(beta), 8, 1e-5, True).numpy()
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
# at different places. The port rounds once, at the store (2^-9 of
# |out|); the JAX paths also round the pre-norm conv output to bf16, an
# error of 2^-9 |y| that the normalisation scales by |gamma| / std. With
# these inputs |y| / std stays below ~3 (bias ~1, conv std ~1), so the
# sum is below 2^-9 * (1 + 3) ~ 8e-3; the bound is 1e-2.
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
