"""K7's plain version (the port's auction EMD) against the JAX package's
XLA formulation and its Pallas kernel in interpret mode, on the CPU.

Given the same d2 the port must return the same assignment and the same
distances, bit for bit: every step is the same f32 operation, and the
ties (exact duplicates) resolve to the lowest index on both sides."""

import re

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
from p2p_bridge_tpu_torch.ops.common import pairwise_sqdist_ordered


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
    x, y = torch.from_numpy(a), torch.from_numpy(b)
    got = emd_auction.auction_emd(x, y, 0.01, 10)
    want = emd_auction.auction_emd_plain(pairwise_sqdist_ordered(x, y), 0.01, 10)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="CUDA card or the CPU"):
        emd_auction.auction_emd(torch.zeros(1, 4, 3, device="meta"),
                                torch.zeros(1, 4, 3, device="meta"), 0.01, 10)


# ------------------------------------------- K7's distances and its cluster
def test_pairwise_sqdist_ordered_is_one_rounding_an_operation():
    """Bit-equal to a float32 numpy loop in the kernel's order:
    a2 = (ax*ax + ay*ay) + az*az, cross = (ax*bx + ay*by) + az*bz,
    max((a2 - 2*cross) + b2, 0)."""
    a, b = clouds(2, 37, 29, False, seed=3)
    a[0, 5] = b[0, 7]  # a pair at distance 0: the clamp
    got = pairwise_sqdist_ordered(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.empty((2, 37, 29), np.float32)
    for k in range(2):
        for n in range(37):
            x = a[k, n]
            a2 = (x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]
            for m in range(29):
                y = b[k, m]
                b2 = (y[0] * y[0] + y[1] * y[1]) + y[2] * y[2]
                cross = (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2]
                want[k, n, m] = max((a2 - np.float32(2) * cross) + b2, np.float32(0))
    np.testing.assert_array_equal(got, want)
    assert got[0, 5, 7] == 0.0


def test_pairwise_sqdist_ordered_matches_jax():
    """Within 1e-6 of the JAX package's pairwise_sqdist (a matrix product,
    which sums in an order of its own) on unit-scale clouds."""
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, size=(3, 200, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(3, 150, 3)).astype(np.float32)
    got = pairwise_sqdist_ordered(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, jax_d2(a, b), rtol=0, atol=1e-6)


AUCTION_SOURCE = (kernels.CSRC / "auction.cu").read_text()
MAX_CLUSTER = int(re.search(r"constexpr int kMaxCluster = (\d+);", AUCTION_SOURCE).group(1))
TAIL = int(re.search(r"constexpr int kTailBidders = (\d+);", AUCTION_SOURCE).group(1))


def cluster_size(B, M, sms):
    """``cluster_size`` of the source."""
    CL = MAX_CLUSTER
    while CL > 1 and (B * CL > sms or CL > M):
        CL //= 2
    return CL


def test_the_source_has_the_modelled_cluster_rule():
    """The lines of the source that ``cluster_size`` and ``split_award``
    model, as the source writes them."""
    for line in ("  int CL = kMaxCluster;\n"
                 "  while (CL > 1 && ((long long)B * CL > sms || CL > M)) CL /= 2;\n"
                 "  return CL;",
                 "const int Mc = (M + CL - 1) / CL, o0 = rank * Mc",
                 "const int share = (nb + CL - 1) / CL, s0 = min(nb, rank * share);",
                 "while (CL > 1 && round < iters && unowned > kTailBidders) {"):
        assert line in AUCTION_SOURCE, line


@pytest.mark.parametrize("B,M,CL", [(32, 2048, 4), (64, 2048, 2), (2, 2048, 8), (200, 2048, 1),
                                    (2, 3, 2)])
def test_cluster_size_fills_one_wave(B, M, CL):
    assert cluster_size(B, M, 132) == CL


def ordered_bits(f: np.float32) -> int:
    u = int(np.float32(f).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


def unordered_bits(u: int) -> np.float32:
    u = (u & 0x7FFFFFFF) if u & 0x80000000 else (~u & 0xFFFFFFFF)
    return np.uint32(u).view(np.float32)


def split_award(d2: np.ndarray, eps: float, iters: int, ranks: int, tail: int = 0):
    """K7's cluster auction for one cloud, one CTA ("rank") after another:
    objects split over the ranks (owners, inboxes), the bidder list split
    into equal slices, bids as 64-bit keys (ordered bid << 32 | N - 1 -
    point) maxed per rank and then per owner, the next list as the bidders
    still unowned in order followed by each rank's evicted points. A rank's
    evictions are listed in the order its award threads reach them, which
    varies from run to run: the model lists them in reverse, which must not
    matter. Once at most ``tail`` points are unowned one rank goes on
    alone. -> (dist [N], assign [N], rounds, bidder rows, fallback
    points)."""
    N, M = d2.shape
    eps = np.float32(eps)
    neg = np.float32(-1e30)
    Mc = -(-M // ranks)
    price = np.zeros(M, np.float32)
    owner = np.full(M, N)
    assign = np.full(N, -1)
    bidders = list(range(N))

    def scan(p):
        value = -d2[p] - price
        best = int(np.argmax(value))
        rest = value.copy()
        rest[best] = neg
        return best, value[best], max(neg, rest.max())

    rounds, unowned, rows = 0, N, 0
    while rounds < iters and unowned > 0:
        if unowned <= tail:
            ranks, Mc = 1, M
        rows += len(bidders)
        share = -(-len(bidders) // ranks)
        inbox = [[0] * M for _ in range(ranks)]  # inbox[r][m]: rank r's highest bid on m
        for r in range(ranks):
            keys = {}
            for p in bidders[r * share:(r + 1) * share]:
                best, v1, v2 = scan(p)
                bid = (v1 - v2) + eps
                keys[best] = max(keys.get(best, 0), ordered_bits(bid) << 32 | (N - 1 - p))
            for m, key in keys.items():
                inbox[r][m] = key
        evicted = [[] for _ in range(ranks)]
        for r in range(ranks):
            for m in range(r * Mc, min(M, (r + 1) * Mc)):
                key = max(inbox[q][m] for q in range(ranks))
                if not key:
                    continue
                winner = N - 1 - (key & 0xFFFFFFFF)
                price[m] = price[m] + unordered_bits(key >> 32)
                old, owner[m], assign[winner] = int(owner[m]), winner, m
                if old < N:
                    assign[old] = -1
                    evicted[r].insert(0, old)
        unowned = N - int((owner < N).sum())
        bidders = [p for p in bidders if assign[p] < 0] + [p for e in evicted for p in e]
        rounds += 1
        assert len(bidders) == unowned
    for p in bidders:
        assign[p] = scan(p)[0]
    return d2[np.arange(N), assign], assign, rounds, rows, len(bidders)


@pytest.mark.parametrize("ranks,tail", [(1, 0), (4, 0), (4, TAIL)])
@pytest.mark.parametrize("B,N,M,eps,iters,integer", CASES)
def test_split_award_equals_the_plain_auction(B, N, M, eps, iters, integer, ranks, tail):
    """The model of the cluster kernel gives the plain auction's assignment
    and distances, bit for bit, on the kernel's own distances: one rank,
    four ranks all the way, and four ranks that hand the tail (from
    kTailBidders unowned points) to one."""
    a, b = clouds(B, N, M, integer, seed=N * M + iters)
    d2 = pairwise_sqdist_ordered(torch.from_numpy(a), torch.from_numpy(b))
    want_d, want_a = emd_auction.auction_emd_plain(d2, eps, iters)
    for k in range(B):
        dist, assign, rounds, rows, left = split_award(d2[k].numpy(), eps, iters, ranks, tail)
        np.testing.assert_array_equal(assign, want_a[k].numpy())
        np.testing.assert_array_equal(dist, want_d[k].numpy())
        assert rows >= N and 1 <= rounds <= iters and (left == 0 or rounds == iters)


def test_auction_emd_on_the_cpu_takes_the_ordered_distances():
    a, b = clouds(2, 40, 40, False, seed=6)
    x, y = torch.from_numpy(a), torch.from_numpy(b)
    got = emd_auction.auction_emd(x, y, eps=0.01, iters=100)
    want = emd_auction.auction_emd_plain(pairwise_sqdist_ordered(x, y), 0.01, 100)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
