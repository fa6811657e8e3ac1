"""attention_type "flash": a TINY PVDS_PUNet with full softmax attention
at the bottleneck against the JAX package on the CPU, its forward and
one training step (the module itself: tests/test_torch_modules.py)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_loss import port_and_jax, wide_tiny
from test_torch_model import GLOBAL_EMBED_TOL, cloud, jax_forward, tiny
from test_torch_train import (assert_step_matches, jax_step_draws, optimizer_cfg,
                              shuffled_batch, to_port)

from p2p_bridge_tpu.models.p2pb import P2PBridge as JaxBridge
from p2p_bridge_tpu.models.unet_pvc import build_unet_from_config as jax_build
from p2p_bridge_tpu.parallel import train_step as jts
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.parallel import train_step as pts
from p2p_bridge_tpu_torch.weights import tensors_to_jax_tree


def with_flash(cfg):
    """cfg with full softmax attention at the bottleneck."""
    cfg = copy.deepcopy(cfg)
    cfg["model"]["PVD"]["attention_type"] = "flash"
    return cfg


def test_unet_flash_attention_forward_matches_jax():
    """attention_type "flash", within GLOBAL_EMBED_TOL as the
    linear-attention model. The weights are the port's initialisation,
    carried to flax by tensors_to_jax_tree (no jitted flax init); the
    attention keeps f32 parameters (tests/test_torch_modules.py holds its
    bf16 input against flax)."""
    cfg = with_flash(tiny(True))
    fmodel = jax_build(Config(cfg))
    template = jax.eval_shape(lambda: fmodel.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 256, 3)), jnp.zeros((1,)), None, True))
    tmodel = build_unet_from_config(cfg).eval()
    init_parameters(tmodel, torch.Generator().manual_seed(0))
    variables = jax.tree.map(jnp.asarray, tensors_to_jax_tree(tmodel.state_dict(), template))
    assert sorted(variables["params"]["global_att"]) == ["to_kv", "to_out", "to_q"]
    assert type(tmodel.global_att).__name__ == "Attention"
    x = cloud(0)
    t = np.array([500.0, 20.0], np.float32)
    want = jax_forward(fmodel, variables, x, t)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 256, 3)
    err = np.abs(got - want).max()
    assert err <= GLOBAL_EMBED_TOL * max(1.0, np.abs(want).max()), err


def test_a_flash_attention_train_step_matches_jax():
    """One step of the 2x-TINY model with full softmax attention at the
    bottleneck (attention_type "flash"; clip 1.0, EMA, no alignment), held
    as test_three_train_steps_match_jax holds the linear-attention model."""
    cfg = wide_tiny(False)
    cfg["model"]["PVD"]["attention_type"] = "flash"
    cfg["diffusion"]["timesteps"] = 40
    cfg.update(optimizer_cfg())
    tmodel, fmodel, variables = port_and_jax(cfg)
    assert type(tmodel.global_att).__name__ == "Attention"
    fb = JaxBridge.from_config(Config(cfg), fmodel)
    opt = jts.make_optimizer(Config(cfg))
    step = jax.jit(jts.make_train_step(fb, opt, grad_clip=1.0, return_grads=True))
    jstate = jts.init_train_state(variables, opt, use_ema=True)
    state = pts.init_train_state(tmodel, cfg)
    key = jax.random.key(0)
    batch = shuffled_batch(np.random.default_rng(3), 2, 256)
    to_port(jstate, state, tmodel)
    steps = jax_step_draws(fb, key, 0, 2)
    jstate, m = step(jstate, key, {n: jnp.asarray(v) for n, v in batch.items()})
    got = pts.train_step(P2PBridge.from_config(cfg, tmodel), state,
                         {n: torch.tensor(v) for n, v in batch.items()},
                         grad_clip=1.0, steps=torch.tensor(steps))
    assert_step_matches(got, m, jstate, state, tmodel, 0)
