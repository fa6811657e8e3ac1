"""The port's approximate EMD and the object half of the metrics facade
(Chamfer, approximate EMD and auction EMD in sub-batches of 4) against the
JAX package on the CPU, inputs from numpy seeds.

Tolerances. The approximate EMD's ten rounds threshold every column at
min(remain / sum, 1), and the first levels weigh distances by
exp(-16384 d2): they amplify the last bit of d2 and of each sum. Moving
every coordinate of one cloud by one ulp moves the JAX package's own cost
by up to 4.4e-3 relative on gaussian clouds (12 seeds, [2, 256] and
300 / 128 points each way); the port, which forms its sums and
exponentials in another order, reads 8.0e-4, 4.0e-3 and 2.6e-3 on the same
seeds. So on such clouds the costs are held to EMD_REL = 1e-2. Where the
problem is well conditioned the agreement is close: on clouds whose points
each have a clear partner the match agrees to 1e-5 of its unit mass
(measured 6e-8), and given the same match the cost is one sum of
match * d2, held to 1e-5 relative (measured 3.3e-7). The auction runs on
clouds of multiples of 1/1024, whose squared distances are exact in f32 in
either framework's form, so the assignments must be equal and the
values agree to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_bridge_tpu import metrics as jax_metrics
from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch import metrics

EMD_REL = 1e-2
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The clouds here are small: torch's ops take microseconds, and CPU
    threads cost more than they give, most of all beside other test
    processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_kernel_launch():
    before = dict(kernels.launch_counts)
    yield
    assert kernels.launch_counts == before


def gaussian(seed, b, n, m):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3)) * 0.5).astype(np.float32), \
        (rng.normal(size=(b, m, 3)) * 0.5).astype(np.float32)


def partnered(seed, b, n):
    """xyz2 a shuffled copy of xyz1, each point moved by about 0.003."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(b, n, 3)) * 0.5).astype(np.float32)
    moved = a[:, rng.permutation(n)] + 0.003 * rng.normal(size=(b, n, 3))
    return a, moved.astype(np.float32)


def dyadic(seed, b, n):
    """Coordinates k / 1024, |k| <= 1024: every square, product and sum of
    the squared distances is exact in f32 (at most 24 significant bits)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(-1024, 1025, size=(b, n, 3)) / 1024).astype(np.float32)
            for _ in range(2)]


def recording(monkeypatch, module, calls):
    """Record what ``module.auction_emd`` returns to its callers."""
    inner = module.auction_emd

    def record(*args, **kwargs):
        out = inner(*args, **kwargs)
        calls.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(module, "auction_emd", record)


def test_approx_match_matches_jax_on_a_well_conditioned_pair():
    a, b = partnered(0, 2, 256)
    got = metrics.approx_match(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_metrics.approx_match(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (2, 256, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=REL)
    # every point of xyz1 is matched with its unit of mass
    np.testing.assert_allclose(got.sum(axis=2), 1.0, atol=1e-4)


@pytest.mark.parametrize("n,m", [(256, 256), (300, 128), (128, 300)])
def test_match_cost_and_emd_match_jax(n, m):
    """N != M takes the integer multipliers (300 // 128 = 2 units of mass
    on each point of the smaller cloud)."""
    a, b = gaussian(n + m, 2, n, m)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want_match = np.asarray(jax_metrics.approx_match(ja, jb))
    got_match = metrics.approx_match(ta, tb)
    assert got_match.shape == (2, n, m)
    mult_l, mult_r = (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)
    assert (got_match.sum(dim=2) <= mult_l + 1e-4).all()
    assert (got_match.sum(dim=1) <= mult_r + 1e-4).all()
    np.testing.assert_allclose(
        metrics.match_cost(ta, tb, torch.from_numpy(want_match)).numpy(),
        np.asarray(jax_metrics.match_cost(ja, jb, jnp.asarray(want_match))), rtol=REL)
    got = metrics.earth_mover_distance(ta, tb).numpy()
    want = np.asarray(jax_metrics.earth_mover_distance(ja, jb))
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=EMD_REL)
    np.testing.assert_allclose(got, metrics.match_cost(ta, tb, got_match).numpy() / n, rtol=REL)


def test_object_facade_matches_jax_across_sub_batches():
    """[5, 256]: two sub-batches of 4 (one mean each for the approximate
    EMD, one value a cloud for Chamfer and the auction)."""
    a, b = gaussian(7, 5, 256, 256)
    got = metrics.calculate_cd(a, b, device="cpu")
    assert len(got) == 5
    np.testing.assert_allclose(got, jax_metrics.calculate_cd(a, b), rtol=REL)
    got = metrics.calculate_emd(a, b, device="cpu")
    assert len(got) == 2
    np.testing.assert_allclose(got, jax_metrics.calculate_emd(a, b), rtol=EMD_REL)
    assert metrics.calculate_cd_cuda is metrics.calculate_cd
    assert metrics.calculate_emd_cuda is metrics.calculate_emd
    assert metrics.calculate_emd_exact_cuda is metrics.calculate_emd_exact


def test_exact_emd_matches_jax_at_the_evaluation_setting(monkeypatch):
    """The auction at eps 0.001 and 10,000 rounds (the Evaluator's) on
    [5, 256]: the same assignment in each sub-batch, values to 1e-6."""
    from p2p_bridge_tpu.metrics import metrics as jax_facade
    from p2p_bridge_tpu_torch.metrics import metrics as port_facade

    got_assign, want_assign = [], []
    recording(monkeypatch, port_facade, got_assign)
    recording(monkeypatch, jax_facade, want_assign)
    a, b = dyadic(8, 5, 256)
    got = metrics.calculate_emd_exact(a, b, eps=0.001, iters=10000, device="cpu")
    want = jax_metrics.calculate_emd_exact(a, b, eps=0.001, iters=10000)
    assert len(got) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert [x.shape for x in got_assign] == [(4, 256), (1, 256)]
    for g, w in zip(got_assign, want_assign, strict=True):
        np.testing.assert_array_equal(g, w)


def test_facade_takes_channels_first_and_refuses_a_missing_card(monkeypatch):
    a, b = gaussian(9, 2, 128, 128)
    np.testing.assert_allclose(
        metrics.calculate_cd(a.transpose(0, 2, 1), b.transpose(0, 2, 1), device="cpu"),
        metrics.calculate_cd(a, b, device="cpu"), rtol=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (metrics.calculate_cd, metrics.calculate_emd, metrics.calculate_emd_exact):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(a, b)
