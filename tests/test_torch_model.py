"""The port's backbone, weights and sampler against the JAX package.

Inputs come from numpy seeds; weights come from a flax init and enter the
port through ``load_jax_params``. The JAX side runs its CPU path (XLA).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parity import TINY

from p2p_bridge_tpu.models.p2pb import P2PBridge as JaxBridge
from p2p_bridge_tpu.models.unet_pvc import build_unet_from_config as jax_build
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu.utils.torch_compat import convert_torch_state_dict
from p2p_bridge_tpu_torch.config import pvds_punet
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config
from p2p_bridge_tpu_torch.weights import (
    flatten_params,
    jax_params_to_state_dict,
    load_jax_params,
    load_torch_state_dict,
)

DIFFUSION = {
    "timesteps": 40, "sampling_timesteps": 8, "objective": "pred_noise",
    "beta_start": 1.0e-4, "beta_end": 0.02, "t0": 1.0e-4, "T": 1.0,
    "ot_ode": True, "loss_type": "mse",
}
# The flax GroupNorm takes the variance as E[x^2] - E[x]^2 in f32. In the
# global-embedding PointNet the broadcast global max makes channels nearly
# constant over the points (mean/std ~ 60 at this init), so that difference
# cancels and the two frameworks' f32 summation orders, 1 ulp apart in
# E[x] and E[x^2], move the conditioning vector by ~8e-4 (measured 8.1e-4
# abs on values ~9). Every AdaGN carries it to the output: measured 3.8e-3
# abs at max|out| 1.5 for one forward. The same model without the global
# embedding agrees to 3e-4 at max|out| 7.3, inside the 1e-4 relative bound.
GLOBAL_EMBED_TOL = 5e-3
TOL = 1e-4


def tiny(global_embedding=True):
    cfg = copy.deepcopy(TINY)
    cfg["model"]["PVD"]["use_global_embedding"] = global_embedding
    cfg["diffusion"] = dict(DIFFUSION)
    return cfg


def build_pair(cfg, n=256, head_scale=1.0):
    """(flax model, flax variables, port model loaded with the same params)."""
    fmodel = jax_build(Config(cfg))
    x = jnp.zeros((1, n, 3), jnp.float32)
    init = jax.jit(lambda k: fmodel.init({"params": k}, x, jnp.zeros((1,)), None, True))
    params = jax.tree.map(np.asarray, init(jax.random.key(0)))
    if head_scale != 1.0:
        head = params["params"]["classifier_out"]
        head["kernel"] = head["kernel"] * np.float32(head_scale)
        head["bias"] = head["bias"] * np.float32(head_scale)
    variables = jax.tree.map(jnp.asarray, params)
    tmodel = build_unet_from_config(cfg).eval()
    load_jax_params(tmodel, params)
    return fmodel, variables, tmodel


@pytest.fixture(scope="module", params=[True, False], ids=["global_embed", "no_global_embed"])
def pair(request):
    cfg = tiny(request.param)
    return (cfg, *build_pair(cfg), GLOBAL_EMBED_TOL if request.param else TOL)


def cloud(seed, b=2, n=256, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(b, n, 3)) * scale).astype(np.float32)


def jax_forward(fmodel, variables, x, t):
    return np.asarray(jax.jit(fmodel.apply, static_argnums=(3, 4))(
        variables, jnp.asarray(x), jnp.asarray(t), None, True))


def test_unet_forward_matches_jax(pair):
    cfg, fmodel, variables, tmodel, tol = pair
    x = cloud(0)
    t = np.array([500.0, 20.0], np.float32)
    want = jax_forward(fmodel, variables, x, t)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 256, 3)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def test_sample_matches_jax(pair):
    """Three reverse steps. The head is scaled by 0.01 so each step moves
    the cloud a little, as a trained denoiser's does: with random
    full-size outputs the chain is chaotic (a 1e-6 move that carries a
    point into the next voxel changes its features by O(1); see
    tests/test_torch_parity.py)."""
    cfg, _, _, _, tol = pair
    fmodel, variables, tmodel = build_pair(cfg, head_scale=0.01)
    x1 = cloud(1, b=1)
    fb = JaxBridge.from_config(Config(cfg), fmodel)
    want = fb.sample(variables, jnp.asarray(x1), steps=3, log_count=3)
    got = P2PBridge.from_config(cfg, tmodel).sample(torch.from_numpy(x1), steps=3, log_count=3)
    for key in ("x_pred", "x_chain", "pred_chain"):
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape, key
        err = np.abs(g - w).max()
        assert err <= tol * max(1.0, np.abs(w).max()), (key, err)


def test_bridge_coefficients_match_jax():
    cfg = tiny()
    fb = JaxBridge.from_config(Config(cfg), None)
    tb = P2PBridge.from_config(cfg, None)
    rng = np.random.default_rng(3)
    x0, x1 = cloud(4), cloud(5)
    steps = rng.integers(0, DIFFUSION["timesteps"], size=2)
    xt_j = np.asarray(fb.q_sample(None, jnp.asarray(steps), jnp.asarray(x0), jnp.asarray(x1)))
    xt_t = tb.q_sample(torch.from_numpy(steps), torch.from_numpy(x0), torch.from_numpy(x1))
    np.testing.assert_allclose(xt_t.numpy(), xt_j, atol=1e-6)
    gt_j = np.asarray(fb.compute_gt(jnp.asarray(steps), jnp.asarray(x0), jnp.asarray(xt_j)))
    gt_t = tb.compute_gt(torch.from_numpy(steps), torch.from_numpy(x0), torch.from_numpy(xt_j))
    np.testing.assert_allclose(gt_t.numpy(), gt_j, rtol=1e-6, atol=1e-6)
    eps = cloud(6)
    for clip in (False, True):
        want = np.asarray(fb.pred_x0_from_eps(0.7, jnp.asarray(x1 * 5), jnp.asarray(eps), clip))
        got = tb.pred_x0_from_eps(0.7, torch.from_numpy(x1 * 5), torch.from_numpy(eps), clip)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_sample_chain_spacing_matches_jax():
    """The flipped, space_indices-spaced chain on a smooth toy network."""

    class ToyTorch(torch.nn.Module):
        def forward(self, x, t, x_cond=None):
            return 0.3 * x + 0.001 * torch.sin(t)[:, None, None]

    class ToyJax:
        def apply(self, params, x, t, x_cond=None, deterministic=True, rngs=None):
            return 0.3 * x + 0.001 * jnp.sin(t)[:, None, None]

    cfg = tiny()
    fb = JaxBridge.from_config(Config(cfg), ToyJax())
    tb = P2PBridge.from_config(cfg, ToyTorch())
    x1 = cloud(7, n=64)
    for steps, log_count in ((8, 8), (8, 3), (4, 2)):
        want = fb.sample(None, jnp.asarray(x1), steps=steps, log_count=log_count)
        got = tb.sample(torch.from_numpy(x1), steps=steps, log_count=log_count)
        np.testing.assert_allclose(got["x_chain"].numpy(), np.asarray(want["x_chain"]), atol=1e-6)
        np.testing.assert_allclose(got["x_pred"].numpy(), np.asarray(want["x_pred"]), atol=1e-6)


def test_stochastic_sample_follows_generator():
    class Zero(torch.nn.Module):
        def forward(self, x, t, x_cond=None):
            return torch.zeros_like(x)

    cfg = tiny()
    cfg["diffusion"]["ot_ode"] = False
    tb = P2PBridge.from_config(cfg, Zero())
    x1 = torch.from_numpy(cloud(8, n=32))
    a = tb.sample(x1, steps=4, generator=torch.Generator().manual_seed(1))["x_pred"]
    b = tb.sample(x1, steps=4, generator=torch.Generator().manual_seed(1))["x_pred"]
    c = tb.sample(x1, steps=4, generator=torch.Generator().manual_seed(2))["x_pred"]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_weights_round_trip_tiny(pair):
    cfg, fmodel, variables, tmodel, tol = pair
    back = convert_torch_state_dict(tmodel.state_dict(), variables)
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(variables)[0], jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))


def test_weights_round_trip_pvds_punet():
    """The full PVDS_PUNet param tree (shapes from jax.eval_shape, values
    from a seed) goes JAX -> port -> JAX unchanged."""
    cfg = pvds_punet()
    cfg["model"]["compute_dtype"] = "f32"
    fmodel = jax_build(Config(cfg))
    shapes = jax.eval_shape(
        lambda: fmodel.init({"params": jax.random.key(0)}, jnp.zeros((1, 2048, 3)),
                            jnp.zeros((1,)), None, True))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    n = sum(x.size for x in jax.tree.leaves(params))
    assert n == 26_441_155
    tmodel = build_unet_from_config(cfg)
    load_jax_params(tmodel, params)
    back = convert_torch_state_dict(tmodel.state_dict(), params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_load_jax_params_is_strict(pair):
    cfg, fmodel, variables, tmodel, tol = pair
    params = jax.tree.map(np.asarray, variables)
    missing = copy.deepcopy(params)
    del missing["params"]["embedf"]["Dense_1"]
    with pytest.raises(KeyError, match="unset"):
        jax_params_to_state_dict(missing, tmodel)
    bad = copy.deepcopy(params)
    k = bad["params"]["classifier_out"]["kernel"]
    bad["params"]["classifier_out"]["kernel"] = k[:-1]
    with pytest.raises(ValueError, match="shape"):
        jax_params_to_state_dict(bad, tmodel)
    extra = copy.deepcopy(params)
    extra["params"]["sa0_conv0"]["attn"] = {"to_out": {"bias": np.zeros(8, np.float32)}}
    with pytest.raises(KeyError):
        jax_params_to_state_dict(extra, tmodel)
    assert len(flatten_params(params)) == len(tmodel.state_dict())


def test_load_torch_state_dict_takes_reference_shapes(pair):
    """A reference checkpoint stores 1x1 convolutions as [out, in, 1(, 1)]."""
    cfg, fmodel, variables, tmodel, tol = pair
    sd = {k: v.clone() for k, v in tmodel.state_dict().items()}
    ref = {k: (v[..., None] if v.dim() == 2 else v) for k, v in sd.items()}
    fresh = build_unet_from_config(cfg)
    load_torch_state_dict(fresh, ref)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    ref.pop("embedf.0.bias")
    with pytest.raises(KeyError, match="missing"):
        load_torch_state_dict(fresh, ref)


def test_compute_dtype_follows_the_config():
    """PVDS_PUNet as shipped (training.amp, no compute_dtype) computes in
    bf16 with f32 parameters, as the JAX package builds it;
    model.compute_dtype wins over training.amp."""
    cfg = pvds_punet()
    with torch.device("meta"):
        model = build_unet_from_config(cfg)
    assert model.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) == 26_441_155
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert jax_build(Config(cfg)).dtype == jnp.bfloat16
    cfg["model"]["compute_dtype"] = "f32"
    with torch.device("meta"):
        assert build_unet_from_config(cfg).dtype == torch.float32
    small = tiny()
    assert build_unet_from_config(small).dtype == torch.float32  # no training section
    small["training"] = {"amp": True}
    assert build_unet_from_config(small).dtype == torch.bfloat16


def bf16_tiny():
    """TINY at four times its widths, computing in bf16. At TINY's own
    widths (GroupNorm groups of 1-2 channels) bf16 rounding is amplified
    layer by layer until JAX's own bf16 and f32 outputs differ by more
    than max|out| with the global embedding; at these widths they differ
    by 3-6% (relative L2, measured on these inputs)."""
    cfg = tiny(True)
    pvd = cfg["model"]["PVD"]
    pvd["channels"] = [32, 32, 64, 64, 128]
    pvd["feat_embed_dim"] = 32
    cfg["model"]["time_embed_dim"] = 32
    cfg["training"] = {"amp": True}
    return cfg


# Relative L2 bound of the bf16 backbone against the JAX bf16 backbone.
# Each framework's bf16 forward is 3-6% from its own f32 forward here
# (measured), and the two round at other places (see
# tests/test_torch_modules.py BF16_TOL), so two bf16 forwards sit that
# far apart: 0.1. The f32 forwards of the same pair agree to 1e-4.
BF16_REL_L2 = 0.1
# That bound alone would pass a port that computes in f32. The precision
# control: the port's bf16 forward must lose as much against its own f32
# forward as JAX's bf16 forward loses against JAX's f32 forward, within a
# factor 1.5 (measured 0.90-0.94 on three inputs; the port rounds a little
# less often, since it adds each bias in the f32 accumulator). A port in
# f32 gives ~0; one whose Linear computes in f32 and rounds only its
# output gives 0.60 and passes BF16_REL_L2 all the same.
# "Nearer to JAX bf16 than JAX f32 is" does not hold and is not asserted:
# two bf16 forwards that round at other places are as far apart as bf16
# is from f32 (measured 0.6-1.4 times), here and at the module level.
BF16_LOSS_RATIO = 1.5


def with_compute_dtype(cfg, name):
    """cfg with model.compute_dtype set to ``name`` ("bf16" or "f32")."""
    return dict(cfg, model=dict(cfg["model"], compute_dtype=name))


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def bf16_pair():
    return build_pair(bf16_tiny())


def test_unet_bf16_forward_matches_jax(bf16_pair):
    fmodel, variables, tmodel = bf16_pair
    assert tmodel.dtype == torch.bfloat16 and fmodel.dtype == jnp.bfloat16
    x = cloud(0)
    t = np.array([500.0, 20.0], np.float32)
    want = jax_forward(fmodel, variables, x, t)
    want32 = jax_forward(jax_build(Config(with_compute_dtype(bf16_tiny(), "f32"))),
                         variables, x, t)
    f32 = build_unet_from_config(with_compute_dtype(bf16_tiny(), "f32")).eval()
    f32.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t))
        got32 = f32(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.dtype == torch.float32  # the head stays f32
    got = got.numpy()
    assert rel_l2(got, want) <= BF16_REL_L2
    assert rel_l2(got32, want32) <= 1e-3  # the f32 twins agree
    ratio = rel_l2(got, got32) / rel_l2(want, want32)
    assert 1 / BF16_LOSS_RATIO <= ratio <= BF16_LOSS_RATIO, ratio
