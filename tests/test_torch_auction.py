"""K7's plain version (the port's auction EMD) against the JAX package's
XLA formulation and its Pallas kernel in interpret mode, on the CPU.

Given the same d2 the port must return the same assignment and the same
distances, bit for bit: every step is the same f32 operation, and the
ties (exact duplicates) resolve to the lowest index on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_bridge_tpu.metrics.emd_auction import _auction_emd_xla
from p2p_bridge_tpu.metrics.emd_auction import align_clean_to_noisy as jax_align
from p2p_bridge_tpu.ops.common import pairwise_sqdist as jax_sqdist
from p2p_bridge_tpu.ops.pallas.auction_kernel import auction_emd_pallas
from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.metrics import emd_auction
from p2p_bridge_tpu_torch.models import loss as port_loss


def jax_d2(a, b):
    """The expanded-form distances as ``_auction_emd_xla`` computes them
    inside its jit (compiled, they round as there)."""
    return np.array(jax.jit(jax_sqdist)(jnp.asarray(a), jnp.asarray(b)))


@pytest.fixture(autouse=True)
def no_kernel_launch():
    before = dict(kernels.launch_counts)
    yield
    assert kernels.launch_counts == before


def clouds(B, N, M, integer, seed):
    """Two point sets; with ``integer`` the coordinates are small integers,
    so the expanded-form distances are exact on both sides and many tie."""
    rng = np.random.default_rng(seed)
    if integer:
        return (rng.integers(-3, 4, size=(B, N, 3)).astype(np.float32),
                rng.integers(-3, 4, size=(B, M, 3)).astype(np.float32))
    return (rng.normal(size=(B, N, 3)).astype(np.float32),
            rng.normal(size=(B, M, 3)).astype(np.float32))


CASES = [
    # B, N, M, eps, iters, integer coordinates
    (2, 64, 64, 0.01, 100, False),
    (2, 64, 64, 0.01, 3, False),     # the budget runs out: greedy fallback
    (2, 48, 64, 0.05, 100, True),    # N < M, exact ties
    (2, 64, 40, 0.01, 100, True),    # N > M: never all assigned
    (3, 32, 32, 0.5, 100, True),
    (1, 24, 24, 0.005, 1, True),     # one round, then the fallback
]


@pytest.mark.parametrize("B,N,M,eps,iters,integer", CASES)
def test_auction_plain_equals_xla_and_pallas(B, N, M, eps, iters, integer):
    a, b = clouds(B, N, M, integer, seed=N * M + iters)
    d2 = jax_d2(a, b)
    got_d, got_a = emd_auction.auction_emd_plain(torch.from_numpy(d2), eps, iters)
    assert got_a.dtype == torch.int32 and got_d.dtype == torch.float32
    want_d, want_a = _auction_emd_xla(jnp.asarray(a), jnp.asarray(b), eps, iters)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    pal_d, pal_a = auction_emd_pallas(jnp.asarray(d2), eps, iters, True)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(pal_a))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(pal_d))


def test_duplicated_points_tie_to_the_lowest_index():
    """Every point of xyz1 duplicated: each pair bids the same on the same
    object, and the lower point index must win, as in both JAX versions."""
    a, b = clouds(1, 16, 32, False, seed=5)
    a = np.concatenate([a, a], axis=1)
    d2 = jax_d2(a, b)
    got_d, got_a = emd_auction.auction_emd_plain(torch.from_numpy(d2), 0.01, 100)
    want_d, want_a = _auction_emd_xla(jnp.asarray(a), jnp.asarray(b), 0.01, 100)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(
        got_a.numpy(), np.asarray(auction_emd_pallas(jnp.asarray(d2), 0.01, 100, True)[1]))


def test_align_clean_to_noisy_undoes_a_permutation():
    """A cloud, permuted and moved by 1e-3: the alignment restores the
    order (the assignment is unambiguous), as the JAX alignment does."""
    rng = np.random.default_rng(0)
    clean = rng.normal(size=(2, 128, 3)).astype(np.float32)
    noisy = clean + 1e-3 * rng.normal(size=clean.shape).astype(np.float32)
    perm = rng.permutation(128)
    shuffled = clean[:, perm]
    got = emd_auction.align_clean_to_noisy(torch.from_numpy(noisy), torch.from_numpy(shuffled),
                                           eps=0.01, iters=100)
    np.testing.assert_array_equal(got.numpy(), clean)
    want = jax_align(jnp.asarray(noisy), jnp.asarray(shuffled), eps=0.01, iters=100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_emd_loss_matches_jax():
    """The EMD loss (eps 0.005, 50 rounds): the mean square root of the
    matched distances; the distances are the expanded form on both sides
    (1e-6 apart), so the losses agree to 1e-5 relative."""
    from p2p_bridge_tpu.models.loss import get_loss as jax_get_loss

    a, b = clouds(2, 64, 64, False, seed=1)
    want = np.asarray(jax_get_loss("emd")(jnp.asarray(a), jnp.asarray(b)))
    got = port_loss.get_loss("emd")(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name in ("mse", "mse_sum", "l1"):
        np.testing.assert_allclose(
            port_loss.get_loss(name)(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
            np.asarray(jax_get_loss(name)(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    with pytest.raises(ValueError):
        port_loss.get_loss("huber")


def test_auction_wrapper_takes_the_plain_version_on_the_cpu():
    a, b = clouds(1, 16, 16, False, seed=2)
    d2 = emd_auction.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b))
    got = emd_auction.auction_emd_assign(d2, 0.01, 10)
    want = emd_auction.auction_emd_plain(d2, 0.01, 10)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    with pytest.raises(ValueError, match="CUDA card or the CPU"):
        emd_auction.auction_emd_assign(torch.zeros(1, 4, 4, device="meta"), 0.01, 10)
