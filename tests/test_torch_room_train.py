"""Room training in the port, on the CPU: the conditioned training step
against the JAX package's ``make_train_step`` over three steps, and the
training CLI on a ScanNet++ tree that the port's preprocessing wrote, whose
run directory the port's denoise_room reads.

The step's model is TINY at twice its widths (tests/test_torch_loss.py
``wide_tiny``) conditioned as PVDL_SNPP is: 8 feature channels embedded by
``feat_embed_dim`` 64, with the global embedding on or off."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loss import wide_tiny
from test_torch_preprocess import write_scene
from test_torch_train import (GRAD_TOL, LR, STEP_REL, TINY_OVERRIDES, jax_step_draws, jax_tree,
                              optimizer_cfg, port_tree, to_port)

from p2p_bridge_tpu.models.p2pb import P2PBridge as JaxBridge
from p2p_bridge_tpu.models.unet_pvc import build_unet_from_config as jax_build
from p2p_bridge_tpu.parallel import train_step as jts
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu_torch.config import PVDL_SNPP
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.parallel import train_step as pts
from p2p_bridge_tpu_torch.weights import tensors_to_jax_tree

ROOT = Path(__file__).resolve().parent.parent
FEATS, N, B = 8, 256, 2
# Without the global embedding the step holds tests/test_torch_train.py's
# STEP_REL and GRAD_TOL in everything but the gradient norm: over the three
# steps the loss agrees to 1.2e-6 and the parameter norm to 1.9e-7
# (relative), every gradient element to 3.8e-5 of the largest, and the
# gradient norm, which moves with those elements, to 1.8e-5 (step 1), so it
# is held to COND_NORM_REL. With the global embedding, the flax GroupNorm's
# E[x^2] - E[x]^2 cancels in the global PointNet (tests/test_torch_model.py
# GLOBAL_EMBED_TOL) and carries each framework's f32 summation order into
# the conditioning vector of every AdaGN: measured 2.2e-4 relative in the
# gradient norm (1.6e-5 in the loss) and 5.7e-4 of the largest gradient
# element (global_pnet's first layers), held to GLOBAL_STEP_REL and
# GLOBAL_GRAD_TOL.
COND_NORM_REL = 5e-5
GLOBAL_STEP_REL = 1e-3
GLOBAL_GRAD_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """TINY widths: torch's CPU threads cost more than they give beside the
    other test processes (tests/test_torch_rooms.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def conditioned_cfg(global_embedding: bool) -> dict:
    cfg = wide_tiny(global_embedding)
    cfg["model"]["extra_feature_channels"] = FEATS
    cfg["model"]["PVD"]["feat_embed_dim"] = PVDL_SNPP["model"]["PVD"]["feat_embed_dim"]
    cfg["data"] = {"npoints": N, "dataset": "ScanNetPP", "point_features": "dino",
                   "use_rgb_features": False}
    cfg["diffusion"]["timesteps"] = 40
    cfg.update(optimizer_cfg())
    return cfg


def conditioned_pair(cfg, seed=0):
    """(port model, flax module, flax variables with the same weights)."""
    fmodel = jax_build(Config(cfg))
    template = jax.eval_shape(lambda: fmodel.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, N, 3)), jnp.zeros((1,)),
        jnp.zeros((1, N, FEATS)), True))
    tmodel = build_unet_from_config(cfg)
    init_parameters(tmodel, torch.Generator().manual_seed(seed))
    # copies: a numpy view of a parameter would let the port's in-place
    # update race the JAX step that reads it
    variables = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                             tensors_to_jax_tree(tmodel.state_dict(), template))
    return tmodel, fmodel, variables


def room_batch(rng):
    """x_gt clean, x_start = clean + noise (x0 = clean), x_cond features."""
    clean = (rng.normal(size=(B, N, 3)) * 0.5).astype(np.float32)
    noisy = clean + (0.03 * rng.normal(size=clean.shape)).astype(np.float32)
    return {"x_gt": clean, "x_start": noisy,
            "x_cond": rng.normal(size=(B, N, FEATS)).astype(np.float32)}


def assert_update_within(got_new, want_new, grad, grad_tol, what):
    """Parameters (or EMA) after a step, per element: Adam's step carries
    the element's own gradient error, grad_tol * max|g| / |g| relative, so
    lr times ten times that plus 1e-3 lr, at most 2 lr (tests/test_torch_train.py
    assert_same_update, at this case's gradient tolerance)."""
    scale = max(np.abs(g).max() for g in grad.values())
    for key, want in want_new.items():
        diff = np.abs(got_new[key] - want)
        allowed = LR * np.minimum(2.0 + 1e-3, 1e-3 + 10 * grad_tol * scale
                                  / np.maximum(np.abs(grad[key]), 1e-30))
        assert (diff <= allowed).all(), (what, key, (diff / allowed).max())
        assert np.isfinite(got_new[key]).all()


@pytest.mark.parametrize("global_embedding", [False, True], ids=["no_global_embed", "global_embed"])
def test_three_conditioned_train_steps_match_jax(global_embedding):
    """Three steps of AdamW (lr 1e-3, weight decay 1e-2), clip 1.0 and the
    EMA, no alignment (room data is paired offline), x_cond through
    embed_feats, each from the JAX step's state: loss, gradient norm,
    parameter norm, the clipped gradients, Adam's moments, the parameters
    and the EMA."""
    step_rel, grad_tol = ((GLOBAL_STEP_REL, GLOBAL_GRAD_TOL) if global_embedding
                          else (STEP_REL, GRAD_TOL))
    norm_rel = {"loss": step_rel, "param_norm": step_rel,
                "grad_norm": GLOBAL_STEP_REL if global_embedding else COND_NORM_REL}
    cfg = conditioned_cfg(global_embedding)
    tmodel, fmodel, variables = conditioned_pair(cfg)
    fb = JaxBridge.from_config(Config(cfg), fmodel)
    opt = jts.make_optimizer(Config(cfg))
    step = jax.jit(jts.make_train_step(fb, opt, grad_clip=1.0, return_grads=True))
    jstate = jts.init_train_state(variables, opt, use_ema=True)
    state = pts.init_train_state(tmodel, cfg)
    bridge = P2PBridge.from_config(cfg, tmodel)
    key = jax.random.key(0)
    rng = np.random.default_rng(0)
    for k in range(3):
        batch = room_batch(rng)
        to_port(jstate, state, tmodel)
        steps = jax_step_draws(fb, key, k, B)
        jstate, m = jax.block_until_ready(
            step(jstate, key, {n: jnp.asarray(v) for n, v in batch.items()}))
        got = pts.train_step(bridge, state, {n: torch.tensor(v) for n, v in batch.items()},
                             grad_clip=1.0, steps=torch.tensor(steps))
        for name in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(got[name]), float(m[name]), rtol=norm_rel[name],
                                       err_msg=f"step {k} {name}")
        clip = min(1.0, 1.0 / (float(m["grad_norm"]) + 1e-6))
        want_g = {n: g * clip for n, g in jax_tree(m["grads"], tmodel).items()}
        got_g = port_tree({n: p.grad for n, p in tmodel.named_parameters()}, tmodel)
        assert any(n.startswith("embed_feats") for n in got_g)
        scale = max(np.abs(g).max() for g in want_g.values())
        for n, g in want_g.items():
            np.testing.assert_allclose(got_g[n], g, atol=grad_tol * scale, err_msg=n)
        adam = jstate.opt_state[0]
        for moment, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            want = jax_tree(tree, tmodel)
            got_m = port_tree({n: state.optimizer.state[p][moment]
                               for n, p in tmodel.named_parameters()}, tmodel)
            mscale = max(np.abs(v).max() for v in want.values())
            for n, v in want.items():
                np.testing.assert_allclose(got_m[n], v, atol=2 * grad_tol * mscale,
                                           err_msg=f"{moment} {n}")
        assert state.step == int(jstate.step) == k + 1
        assert_update_within(port_tree(dict(tmodel.named_parameters()), tmodel),
                             jax_tree(jstate.params, tmodel), want_g, grad_tol, "params")
        assert state.ema.step == int(jstate.ema.step)
        assert_update_within(port_tree(state.ema.params, tmodel),
                             jax_tree(jstate.ema.params, tmodel), want_g, grad_tol, "ema")


# ---------------------------------------------------------------- the CLI
ROOM_OVERRIDES = [tok for pair in zip(TINY_OVERRIDES[::2], TINY_OVERRIDES[1::2])
                  if pair[0] != "--data.pool_size" for tok in pair]  # epoch loader: no pool


def snpp_tree(root: Path) -> Path:
    """Two training scenes and one validation scene written as ScanNet++
    scans, made into 256-point batches by the port's preprocess_batches,
    and the split files."""
    from p2p_bridge_tpu_torch import preprocess_batches

    for i, scene in enumerate(("train0", "train1", "val0")):
        write_scene(root / "scenes" / scene, seed=20 + i, n=2500)
    preprocess_batches.main(["--data_root", str(root / "scenes"), "--output_root",
                             str(root / "batches"), "--npoints", "256", "--r", "0.4",
                             "--feature_type", "dino", "--workers", "1"])
    (root / "splits").mkdir()
    (root / "splits" / "snpp_train.txt").write_text("train0\ntrain1\n")
    (root / "splits" / "snpp_val.txt").write_text("val0\n")
    return root


def test_room_training_cli_writes_a_run_that_denoise_room_reads(tmp_path):
    """python -m p2p_bridge_tpu_torch.train --config configs/PVDL_SNPP.yaml on
    the CPU, TINY widths conditioned on the tree's 6 feature channels (bf16 as
    shipped): four steps through the epoch loader, an in-training evaluation
    after the fourth, opt.yaml and model.pt; then python -m
    p2p_bridge_tpu_torch.denoise_room with that run directory denoises a
    validation scene's scan with its features."""
    import json

    snpp_tree(tmp_path)
    n_batches = {d.name: len(list(d.glob("points_*.npz"))) for d in (tmp_path / "batches").iterdir()}
    assert all(n > 0 for n in n_batches.values()) and len(n_batches) == 3
    env = {k: v for k, v in os.environ.items() if k != "P2PB_PLATFORM"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")  # TINY widths: one thread
    train = subprocess.run(
        [sys.executable, "-m", "p2p_bridge_tpu_torch.train", "--config",
         str(ROOT / "configs" / "PVDL_SNPP.yaml"), "--save_dir", str(tmp_path / "runs"),
         "--device", "cpu", "--data.data_dir", str(tmp_path / "batches"),
         "--data.splits_path", str(tmp_path / "splits"), "--training.steps", "4",
         "--training.log_interval", "1", "--training.viz_interval", "4",
         "--training.bs", "2", "--sampling.bs", "2", "--training.eval_max_batches", "1",
         "--diffusion.sampling_timesteps", "2", "--model.extra_feature_channels", "6",
         *ROOM_OVERRIDES],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr
    run = tmp_path / "runs" / "PVDL_SNPP"
    assert {"model.pt", "opt.yaml", "metrics.jsonl"} <= set(os.listdir(run))
    ckpt = torch.load(run / "model.pt", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["ema"] is not None
    assert any(k.startswith("embed_feats") for k in ckpt["model"])  # x_cond's embedding
    recs = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    evals = [r for r in recs if "eval/CD" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert len(evals) == 1 and evals[0]["step"] == 4
    assert all(np.isfinite(v) for k, v in evals[0].items() if k.startswith("eval/"))

    scan = tmp_path / "scenes" / "val0" / "scans" / "iphone.ply"
    denoise = subprocess.run(
        [sys.executable, "-m", "p2p_bridge_tpu_torch.denoise_room", "--room_path", str(scan),
         "--model_path", str(run), "--device", "cpu", "--steps", "2", "--k", "1",
         "--batch_size", "4", "--out_path", str(tmp_path / "pred.ply")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert denoise.returncode == 0, denoise.stderr
    from p2p_bridge_tpu_torch.utils.io import read_ply

    pred = read_ply(str(tmp_path / "pred.ply"))["points"]
    assert pred.shape == (2500, 3) and np.isfinite(pred).all()
