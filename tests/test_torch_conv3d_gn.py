"""conv3d_gn of the port against the JAX package's conv + GroupNorm.

The port's CPU path (the plain version of kernel K1) is held against the
XLA composition (_ref_conv + _apply_gn_xla) and against the windowed Pallas
kernel wconv3d_gn_pallas in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_bridge_tpu.ops.pallas import wconv3d_kernel
from p2p_bridge_tpu.ops.pallas.conv3d_kernel import _apply_gn_xla, _ref_conv_gn
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
