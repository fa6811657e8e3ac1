"""The port's training loss and its gradient against the JAX package's
``P2PBridge.loss_fn`` and ``jax.value_and_grad``, on the CPU.

The weights are drawn in PyTorch (``init_parameters``) and enter the JAX
tree through ``weights.tensors_to_jax_tree``; the timesteps are JAX's own
draw from the same key (``split(rng, 4)[0]``, as p2pb.py:123-124), handed to
the port. Dropout is 0 and ``ot_ode`` is on, so nothing else is random.

The model is TINY at twice its widths. At TINY's own widths each PVConv
GroupNorm group holds one channel, so the squeeze-excite input (the grid
mean of a zero-mean group) is 0 in exact arithmetic and its ReLU sits at
its kink: rounding alone decides whether the gate passes a gradient, and
the gradient of the norm's bias changes with it, on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import GLOBAL_EMBED_TOL, TOL, tiny

from p2p_bridge_tpu.models.p2pb import P2PBridge as JaxBridge
from p2p_bridge_tpu.models.unet_pvc import build_unet_from_config as jax_build
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.weights import flatten_params, tensors_to_jax_tree


def wide_tiny(global_embedding: bool) -> dict:
    """TINY at twice its widths: two channels per GroupNorm group."""
    cfg = tiny(global_embedding)
    cfg["model"]["PVD"]["channels"] = [16, 16, 32, 32, 64]
    cfg["model"]["PVD"]["feat_embed_dim"] = 16
    return cfg


def port_and_jax(cfg, n=256, seed=0):
    """(port model, flax module, flax variables holding the same weights)."""
    fmodel = jax_build(Config(cfg))
    template = jax.eval_shape(lambda: fmodel.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, n, 3)), jnp.zeros((1,)), None, True))
    tmodel = build_unet_from_config(cfg)
    init_parameters(tmodel, torch.Generator().manual_seed(seed))
    variables = jax.tree.map(jnp.asarray, tensors_to_jax_tree(tmodel.state_dict(), template))
    return tmodel, fmodel, variables


def batch(seed, b=2, n=256):
    rng = np.random.default_rng(seed)
    x0 = (rng.normal(size=(b, n, 3)) * 0.5).astype(np.float32)
    x1 = x0 + (0.05 * rng.normal(size=x0.shape)).astype(np.float32)
    return x0, x1


def jax_steps(bridge, key, b):
    """The timesteps JAX's loss_fn draws from ``key``."""
    return np.asarray(jax.random.randint(jax.random.split(key, 4)[0], (b,), 0,
                                         bridge.schedule.timesteps))


def jax_loss_and_grads(cfg, fmodel, variables, x0, x1, key):
    fb = JaxBridge.from_config(Config(cfg), fmodel)
    fn = jax.jit(jax.value_and_grad(
        lambda p: fb.loss_fn(p, key, jnp.asarray(x0), jnp.asarray(x1), None, train=True)))
    loss, grads = fn(variables)
    return float(loss), jax.tree.map(np.asarray, grads), jax_steps(fb, key, x0.shape[0])


def port_loss_and_grads(cfg, tmodel, x0, x1, steps, template):
    tmodel.zero_grad(set_to_none=True)
    loss = P2PBridge.from_config(cfg, tmodel.train()).loss_fn(
        torch.tensor(x0), torch.tensor(x1), steps=torch.tensor(steps))
    loss.backward()
    loss = loss.detach()
    grads = tensors_to_jax_tree({n: p.grad for n, p in tmodel.named_parameters()}, template)
    return float(loss), grads


@pytest.mark.parametrize("global_embedding", [True, False], ids=["global_embed", "no_global_embed"])
def test_loss_and_gradient_match_jax(global_embedding):
    """f32: the loss and every parameter's gradient within the forward's
    tolerance (test_torch_model.py: TOL, or GLOBAL_EMBED_TOL where the
    global embedding's GroupNorm cancels), times max(1, max|leaf|)."""
    cfg = wide_tiny(global_embedding)
    tol = GLOBAL_EMBED_TOL if global_embedding else TOL
    tmodel, fmodel, variables = port_and_jax(cfg)
    x0, x1 = batch(0)
    want_loss, want, steps = jax_loss_and_grads(cfg, fmodel, variables, x0, x1,
                                                jax.random.key(3))
    got_loss, got = port_loss_and_grads(cfg, tmodel, x0, x1, steps, variables)
    assert abs(got_loss - want_loss) <= tol * max(1.0, abs(want_loss))
    flat_got, flat_want = flatten_params(got), flatten_params(want)
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        err = np.abs(flat_got[path] - w).max()
        assert err <= tol * max(1.0, np.abs(w).max()), ("/".join(path), err)


def rel_l2(got, want):
    g = np.concatenate([x.ravel() for x in jax.tree.leaves(got)])
    w = np.concatenate([x.ravel() for x in jax.tree.leaves(want)])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))
