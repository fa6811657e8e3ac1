"""The port's training step, optimizer, schedule and EMA against the JAX
package's ``make_train_step``, ``make_optimizer`` and ``ema_update``, and
the training CLI end to end, on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_loss import port_and_jax, wide_tiny

from export_jax_checkpoint import checkpoint_arrays
from p2p_bridge_tpu.models.p2pb import P2PBridge as JaxBridge
from p2p_bridge_tpu.models.schedules import BridgeSchedule as JaxSchedule
from p2p_bridge_tpu.parallel import train_step as jts
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu.utils.ema import EmaState as JaxEma
from p2p_bridge_tpu.utils.ema import ema_update as jax_ema_update
from p2p_bridge_tpu_torch.models.model_loader import restore_jax_checkpoint
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.schedules import BridgeSchedule
from p2p_bridge_tpu_torch.parallel import train_step as pts
from p2p_bridge_tpu_torch.utils.ema import ema_init, ema_update
from p2p_bridge_tpu_torch.weights import jax_params_to_state_dict

ROOT = Path(__file__).resolve().parent.parent
ALIGN = {"eps": 0.01, "iters": 100}
LR = 1e-3


def optimizer_cfg(kind="AdamW", scheduler="constant", wd=1e-2, lr=LR):
    return {"training": {"optimizer": {"type": kind, "lr": lr, "beta1": 0.9, "beta2": 0.999,
                                       "weight_decay": wd},
                         "scheduler": {"type": scheduler, "lr_gamma": 0.99}}}


def shuffled_batch(rng, b, n, noise=0.05):
    """A noisy cloud and its clean cloud in another order: the alignment
    has to undo the permutation."""
    clean = (rng.normal(size=(b, n, 3)) * 0.5).astype(np.float32)
    noisy = clean + (noise * rng.normal(size=clean.shape)).astype(np.float32)
    return {"x_gt": clean[:, rng.permutation(n)], "x_start": noisy}


def jax_step_draws(bridge, key, step, batch_size, accum=1):
    """The timesteps make_train_step draws at ``step``, in batch order."""
    rng = jax.random.fold_in(key, step)
    micro = batch_size // accum
    rngs = jax.random.split(rng, accum) if accum > 1 else [rng]
    return np.concatenate([np.asarray(jax.random.randint(
        jax.random.split(r, 4)[0], (micro,), 0, bridge.schedule.timesteps)) for r in rngs])


def to_port(jstate, state, model):
    """Load the JAX TrainState (params, Adam moments and count, EMA, step)
    into the port's TrainState: the exporter's layout of it, read by the
    port's import. The JAX EMA's count is kept (these steps go on from one
    state; a resume restarts it)."""
    ckpt = {"params": jstate.params, "ema": jstate.ema.params, "opt_state": jstate.opt_state,
            "step": jstate.step}
    restore_jax_checkpoint(checkpoint_arrays(ckpt, "AdamW"), state)
    state.ema.step = int(jstate.ema.step)


def port_tree(tensors, model):
    """{torch key: tensor} of the model's parameters -> {torch key: numpy}."""
    return {k: v.detach().numpy() for k, v in tensors.items()}


def jax_tree(tree, model):
    return {k: v.numpy() for k, v in jax_params_to_state_dict(
        jax.tree.map(np.asarray, tree), model).items()}


# One step from the same state (2x TINY, f32): the loss and the norms
# agree to STEP_REL relative, every gradient element to GRAD_TOL of the
# largest (sums in another order; measured: 2.1e-6, 5.4e-6 and 1e-7
# relative, gradients 4.4e-5 of the largest). Adam divides each
# gradient element by its own running magnitude, so an element's step
# carries that element's relative error, GRAD_TOL * max|g| / |g|: the test
# allows lr times ten times that, plus 1e-3 lr, and at most 2 lr (the
# first step is lr * sign(g): an element whose gradient is within the
# noise may step the other way).
STEP_REL = 1e-5
GRAD_TOL = 1e-4


def assert_same_update(got_new, want_new, grad, what):
    """Parameters (or EMA) after a step: the same update per element."""
    scale = max(np.abs(g).max() for g in grad.values())
    for key, want in want_new.items():
        diff = np.abs(got_new[key] - want)
        allowed = LR * np.minimum(2.0 + 1e-3, 1e-3 + 10 * GRAD_TOL * scale
                                  / np.maximum(np.abs(grad[key]), 1e-30))
        assert (diff <= allowed).all(), (what, key, (diff / allowed).max())
        assert np.isfinite(got_new[key]).all()


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = wide_tiny(False)
    cfg["diffusion"]["timesteps"] = 40
    cfg.update(optimizer_cfg())
    tmodel, fmodel, variables = port_and_jax(cfg)
    return cfg, tmodel, fmodel, variables


def test_three_train_steps_match_jax(tiny_pair):
    """Three steps of AdamW (lr 1e-3, weight decay 1e-2) with clip 1.0,
    the EMA and the auction alignment on, each from the JAX step's state:
    loss, gradient norm, parameter norm, the clipped gradients, Adam's
    moments, the parameters and the EMA."""
    cfg, tmodel, fmodel, variables = tiny_pair
    fb = JaxBridge.from_config(Config(cfg), fmodel)
    opt = jts.make_optimizer(Config(cfg))
    step = jax.jit(jts.make_train_step(fb, opt, grad_clip=1.0, align_cfg=ALIGN,
                                       return_grads=True))
    jstate = jts.init_train_state(variables, opt, use_ema=True)
    state = pts.init_train_state(tmodel, cfg)
    bridge = P2PBridge.from_config(cfg, tmodel)
    key = jax.random.key(0)
    rng = np.random.default_rng(0)
    for k in range(3):
        batch = shuffled_batch(rng, 2, 256)
        to_port(jstate, state, tmodel)
        steps = jax_step_draws(fb, key, k, 2)
        jstate, m = step(jstate, key, {n: jnp.asarray(v) for n, v in batch.items()})
        got = pts.train_step(bridge, state, {n: torch.tensor(v) for n, v in batch.items()},
                             grad_clip=1.0, align_cfg=ALIGN, steps=torch.tensor(steps))
        assert_step_matches(got, m, jstate, state, tmodel, k)


def assert_step_matches(got, m, jstate, state, tmodel, k):
    """The port's step ``k`` (its metrics ``got`` and ``state``) against
    the JAX step's (``m``, ``jstate``) from the same state: loss and
    norms, the clipped gradients, Adam's moments, the parameters, the EMA."""
    for name in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(float(got[name]), float(m[name]), rtol=STEP_REL,
                                   err_msg=f"step {k} {name}")
    clip = min(1.0, 1.0 / (float(m["grad_norm"]) + 1e-6))
    want_g = {n: g * clip for n, g in jax_tree(m["grads"], tmodel).items()}
    got_g = port_tree({n: p.grad for n, p in tmodel.named_parameters()}, tmodel)
    scale = max(np.abs(g).max() for g in want_g.values())
    for n, g in want_g.items():
        np.testing.assert_allclose(got_g[n], g, atol=GRAD_TOL * scale, err_msg=n)
    adam = jstate.opt_state[0]
    for moment, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = jax_tree(tree, tmodel)
        got_m = port_tree({n: state.optimizer.state[p][moment]
                           for n, p in tmodel.named_parameters()}, tmodel)
        mscale = max(np.abs(v).max() for v in want.values())
        for n, v in want.items():
            np.testing.assert_allclose(got_m[n], v, atol=2 * GRAD_TOL * mscale,
                                       err_msg=f"{moment} {n}")
    assert state.step == int(jstate.step) == k + 1
    assert_same_update(port_tree(dict(tmodel.named_parameters()), tmodel),
                       jax_tree(jstate.params, tmodel), want_g, "params")
    assert state.ema.step == int(jstate.ema.step)
    assert_same_update(port_tree(state.ema.params, tmodel), jax_tree(jstate.ema.params, tmodel),
                       want_g, "ema")


class JaxLinear:
    def apply(self, params, xt, noise_levels, x_cond=None, deterministic=True, rngs=None):
        return params["w"] * xt + params["b"]


class PortLinear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(1.0))
        self.b = torch.nn.Parameter(torch.tensor(0.0))

    def forward(self, xt, t, x_cond=None):
        return self.w * xt + self.b


@pytest.mark.parametrize("kind,scheduler,accum", [
    ("Adam", "constant", 1),        # weight decay added to the gradient (L2)
    ("AdamW", "StepLR", 1),
    ("AdamW", "ExponentialLR", 1),
    ("AdamW", "constant", 2),       # two micro-batches: mean loss, mean gradients
], ids=["adam_l2", "steplr", "exponentiallr", "accumulation_2"])
def test_optimizer_variants_match_jax(kind, scheduler, accum):
    """On the closed-form bridge of tests/test_train_step.py (w * x + b):
    five steps of each optimizer, schedule and accumulation variant with
    clip 1.0, EMA and alignment, parameters and moments to 1e-5."""
    cfg = optimizer_cfg(kind, scheduler, wd=0.1, lr=1e-2)
    sched = JaxSchedule.create(timesteps=100)
    fb = JaxBridge(model=JaxLinear(), schedule=sched, ot_ode=True)
    opt = jts.make_optimizer(Config(cfg))
    step = jax.jit(jts.make_train_step(fb, opt, grad_clip=1.0, accumulation_steps=accum,
                                       align_cfg=ALIGN))
    jstate = jts.init_train_state({"w": jnp.ones(()), "b": jnp.zeros(())}, opt)
    model = PortLinear()
    bridge = P2PBridge(model=model, schedule=BridgeSchedule.create(timesteps=100))
    state = pts.init_train_state(model, cfg)
    key = jax.random.key(1)
    rng = np.random.default_rng(1)
    for k in range(5):
        batch = shuffled_batch(rng, 8, 16, noise=0.3)
        steps = jax_step_draws(fb, key, k, 8, accum)
        jstate, m = step(jstate, key, {n: jnp.asarray(v) for n, v in batch.items()})
        got = pts.train_step(bridge, state, {n: torch.tensor(v) for n, v in batch.items()},
                             grad_clip=1.0, accumulation_steps=accum, align_cfg=ALIGN,
                             steps=torch.tensor(steps))
        np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), float(m["grad_norm"]), rtol=1e-5)
        for name in ("w", "b"):
            p = getattr(model, name)
            np.testing.assert_allclose(p.item(), float(jstate.params[name]), rtol=1e-5, atol=1e-7)
            # the first moment to 1e-4 of the gradient's scale sqrt(nu)
            # (b's gradient changes sign, so its mean nearly cancels)
            adam = jstate.opt_state[-1][0] if kind == "Adam" else jstate.opt_state[0]
            nu = float(adam.nu[name])
            np.testing.assert_allclose(state.optimizer.state[p]["exp_avg_sq"].item(), nu, rtol=1e-4)
            np.testing.assert_allclose(state.optimizer.state[p]["exp_avg"].item(),
                                       float(adam.mu[name]), atol=1e-4 * nu ** 0.5)
            np.testing.assert_allclose(state.ema.params[name].item(),
                                       float(jstate.ema.params[name]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("scheduler", ["constant", "StepLR", "ExponentialLR"])
def test_learning_rate_follows_optax(scheduler):
    """The rate at update number ``count`` equals optax's schedule, across
    StepLR's 10,000-step staircase."""
    cfg = optimizer_cfg(scheduler=scheduler)
    gamma = cfg["training"]["scheduler"]["lr_gamma"]
    want = {"constant": lambda c: LR,
            "StepLR": optax.exponential_decay(LR, 10_000, 0.9, staircase=True),
            "ExponentialLR": optax.exponential_decay(LR, 1, gamma)}[scheduler]
    factor = pts.learning_rate_factor(cfg)
    for count in (0, 1, 2, 9_999, 10_000, 10_001, 25_000):
        if scheduler == "ExponentialLR" and count > 100:
            continue  # gamma ** count underflows to the same 0 on both sides
        np.testing.assert_allclose(LR * factor(count), float(want(count)), rtol=1e-5)
    optimizer, schedule = pts.make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])
    for count in range(3):
        np.testing.assert_allclose(optimizer.param_groups[0]["lr"], float(want(count)), rtol=1e-6)
        optimizer.step()
        schedule.step()


def test_ema_update_matches_jax_across_the_copy_and_move_phases():
    """Updates 100-121: a copy at 100, no move at 101-109 and 111-119, the
    warmed-up decay at 110 and 120."""
    rng = np.random.default_rng(2)
    start = {"w": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=4).astype(np.float32)}
    state = ema_init({k: torch.tensor(v) for k, v in start.items()})
    state.step = 99
    jstate = JaxEma({k: jnp.asarray(v) for k, v in start.items()}, jnp.int32(99))
    for step in range(100, 122):
        params = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in start.items()}
        before = {k: v.clone() for k, v in state.params.items()}
        ema_update(state, {k: torch.tensor(v) for k, v in params.items()})
        jstate = jax_ema_update(jstate, {k: jnp.asarray(v) for k, v in params.items()})
        assert state.step == int(jstate.step) == step
        for k in start:
            np.testing.assert_allclose(state.params[k].numpy(), np.asarray(jstate.params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{step} {k}")
        if step == 100:
            assert all(np.array_equal(state.params[k].numpy(), params[k]) for k in start)
        elif step % 10:
            assert all(torch.equal(state.params[k], before[k]) for k in start)


def synthetic_tree(root: Path, n=600, clouds=2):
    """A PUNet tree of small clouds at the three training resolutions and
    the test split the loader opens."""
    rng = np.random.default_rng(0)
    for split, res in (("train", ("10000", "30000", "50000")), ("test", ("10000",))):
        for r in res:
            d = root / "PUNet" / "pointclouds" / split / f"{r}_poisson"
            d.mkdir(parents=True)
            for i in range(clouds):
                p = rng.normal(size=(n, 3))
                p /= np.linalg.norm(p, axis=1, keepdims=True)
                np.savetxt(d / f"shape{i}.xyz", p.astype(np.float32), fmt="%.6f")


TINY_OVERRIDES = [
    "--data.npoints", "256", "--data.pool_size", "8", "--training.bs", "2",
    "--model.PVD.channels", "[8, 8, 16, 16, 32]", "--model.PVD.voxel_resolutions", "[8, 4, 4, 4]",
    "--model.PVD.global_embedding_dim", "64", "--model.PVD.feat_embed_dim", "8",
    "--model.PVD.attention_heads", "2", "--model.PVD.radius", "[0.2, 0.4, 0.8, 1.2]",
    "--model.PVD.out_mlp", "16", "--model.time_embed_dim", "16",
    "--model.PVD.n_sa_blocks", "[1, 1, 1, 1]", "--model.PVD.n_fp_blocks", "[1, 1, 1, 1]",
]


def test_train_cli_writes_a_checkpoint_that_denoise_object_reads(tmp_path):
    """python -m p2p_bridge_tpu_torch.train on the CPU with TINY widths (bf16
    as shipped), two steps, a save every step; then denoise_object with
    --use_ema reads model.pt and opt.yaml."""
    synthetic_tree(tmp_path / "data")
    env = {k: v for k, v in os.environ.items() if k != "P2PB_PLATFORM"}
    env["PYTHONPATH"] = str(ROOT)
    train = subprocess.run(
        [sys.executable, "-m", "p2p_bridge_tpu_torch.train", "--config",
         str(ROOT / "configs" / "PVDS_PUNet.yaml"), "--save_dir", str(tmp_path / "runs"),
         "--device", "cpu", "--data.data_dir", str(tmp_path / "data"), "--training.steps", "2",
         "--training.save_interval", "1", "--training.log_interval", "1", *TINY_OVERRIDES],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr
    run = tmp_path / "runs" / "PVDS_PUNet"
    assert {"model.pt", "opt.yaml"} <= set(os.listdir(run))
    assert "netgradNorm" in train.stderr and "Saved final" not in train.stderr
    ckpt = torch.load(run / "model.pt", weights_only=True)
    assert ckpt["step"] == 2 and set(ckpt) >= {"model", "ema", "optimizer", "step"}
    cloud = tmp_path / "cloud.xyz"
    np.savetxt(cloud, np.random.default_rng(1).normal(size=(700, 3)).astype(np.float32))
    denoise = subprocess.run(
        [sys.executable, "-m", "p2p_bridge_tpu_torch.denoise_object", "--data_path", str(cloud),
         "--model_path", str(run / "model.pt"), "--device", "cpu", "--use_ema", "--steps", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert denoise.returncode == 0, denoise.stderr
    out = np.loadtxt(tmp_path / "cloud_denoised.xyz")
    assert out.shape == (700, 3) and np.isfinite(out).all()


def test_checkpoint_round_trip_restores_the_whole_state(tmp_path):
    """save_checkpoint -> restore_checkpoint into a fresh TrainState: the
    model, EMA, Adam moments, schedule and step; with ``restart`` only the
    model weights."""
    from p2p_bridge_tpu_torch.models.model_loader import restore_checkpoint, save_checkpoint

    cfg = optimizer_cfg(scheduler="ExponentialLR")
    rng = np.random.default_rng(3)

    def fresh():
        model = PortLinear()
        return model, pts.init_train_state(model, cfg), P2PBridge(
            model=model, schedule=BridgeSchedule.create(timesteps=100))

    model, state, bridge = fresh()
    for _ in range(3):
        batch = shuffled_batch(rng, 4, 16, noise=0.3)
        pts.train_step(bridge, state, {n: torch.tensor(v) for n, v in batch.items()},
                       generator=torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), state)
    assert path == str(tmp_path / "model.pt")
    for restart in (False, True):
        model2, state2, _ = fresh()
        restore_checkpoint(path, state2, restart=restart)
        assert torch.equal(model2.w, model.w) and torch.equal(model2.b, model.b)
        if restart:
            assert state2.step == 0 and not state2.optimizer.state
            continue
        assert state2.step == state.step == 3 and state2.ema.step == state.ema.step
        assert state2.schedule.last_epoch == state.schedule.last_epoch == 3
        assert state2.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]
        for p, q in zip(model.parameters(), model2.parameters()):
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(state.optimizer.state[p][key], state2.optimizer.state[q][key])
        assert all(torch.equal(state.ema.params[k], state2.ema.params[k]) for k in ("w", "b"))


@pytest.fixture
def p2pb_records(monkeypatch):
    """Let the "p2pb" logger's records reach caplog: the JAX package's
    setup_logger, which other test modules import, stops them at that
    logger."""
    import logging

    monkeypatch.setattr(logging.getLogger("p2pb"), "propagate", True)


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_load_matched_weights_partial(caplog, p2pb_records):
    """A tensor whose name and shape match is copied; a shape mismatch and
    a tensor the checkpoint lacks keep the fresh values, each with a
    warning; a key the model lacks is ignored. The strict loader refuses
    the same dict."""
    from p2p_bridge_tpu_torch.models.model_loader import load_matched_weights

    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Linear(2, 3))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = {"0.weight": torch.ones(2, 2), "0.bias": torch.ones(5),  # shape mismatch
              "1.weight": torch.full((3, 2), 2.0), "unknown": torch.ones(1)}  # 1.bias missing
    with caplog.at_level("WARNING", logger="p2pb"):
        n_loaded, n_skipped = load_matched_weights(model, loaded)
    assert (n_loaded, n_skipped) == (2, 2)
    sd = model.state_dict()
    assert torch.equal(sd["0.weight"], torch.ones(2, 2))
    assert torch.equal(sd["1.weight"], torch.full((3, 2), 2.0))
    assert torch.equal(sd["0.bias"], fresh["0.bias"]) and torch.equal(sd["1.bias"], fresh["1.bias"])
    warned = [r.getMessage() for r in caplog.records]
    assert any("0.bias shape mismatch" in m for m in warned)
    assert any("1.bias not found in checkpoint" in m for m in warned)
    with pytest.raises(RuntimeError):
        model.load_state_dict(loaded, strict=True)


def loop_cfg(tmp_path, name, *extra):
    """The training CLI's configuration at TINY widths on the synthetic
    tree, exact epochs (data.loader epoch), 16 steps, evaluations of one
    val batch of 2 patches."""
    from p2p_bridge_tpu_torch.utils.args import parse_args

    return parse_args(["--config", str(ROOT / "configs" / "PVDS_PUNet.yaml"),
                       "--save_dir", str(tmp_path / "runs"), "--name", name,
                       "--data.data_dir", str(tmp_path / "data"), "--data.loader", "epoch",
                       "--training.steps", "16", "--training.log_interval", "1",
                       "--training.save_interval", "1000", "--diffusion.sampling_timesteps", "2",
                       "--training.eval_max_batches", "1", "--sampling.bs", "2", *TINY_OVERRIDES,
                       *extra])


def test_training_loop_evaluates_watches_and_profiles(tmp_path, one_thread):
    """16 CPU steps with an evaluation every 2 steps (with the EMA
    weights), histograms of the parameters and of the gradients every 4 and
    a profile of steps 10-14: metrics.jsonl holds the losses and the eval
    keys, histograms.jsonl a row of every parameter at each watch step, the
    trace is written, and the parameters and EMA end bit-equal to those of
    a run that does none of it."""
    import json

    from p2p_bridge_tpu_torch.train import train

    synthetic_tree(tmp_path / "data")
    plain = train(loop_cfg(tmp_path, "plain"), "cpu")
    cfg = loop_cfg(tmp_path, "watched", "--training.viz_interval", "2",
                   "--training.watch_interval", "4", "--training.watch_gradients", "true",
                   "--profile_dir", str(tmp_path / "trace"), "--use_ema")
    state = train(cfg, "cpu")
    for a, b in zip(plain.model.parameters(), state.model.parameters(), strict=True):
        assert torch.equal(a, b)
    assert all(torch.equal(plain.ema.params[k], v) for k, v in state.ema.params.items())

    run = Path(cfg["output_dir"])
    recs = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == list(range(16))
    evals = [r for r in recs if "eval/CD" in r]
    assert [r["step"] for r in evals] == list(range(2, 17, 2))
    for r in evals:
        assert all(np.isfinite(r[f"eval/{p}{k}"]) for p in ("", "noisy_")
                   for k in ("CD", "EMD", "MSE"))
    names = {n for n, _ in state.model.named_parameters()}
    hists = [json.loads(x) for x in (run / "histograms.jsonl").read_text().splitlines()]
    assert [h["step"] for h in hists] == [4, 4, 8, 8, 12, 12, 16, 16]
    for h in hists:
        prefix = next(iter(h["hists"])).split("/")[0]
        assert prefix in ("param", "grad")
        assert set(h["hists"]) == {f"{prefix}/{n}" for n in names}
    assert os.listdir(tmp_path / "trace") == ["trace_steps_10_14.json"]
    assert "0000016_pred.png" in os.listdir(run / "output")


def test_training_loop_survives_a_failed_evaluation(tmp_path, monkeypatch, caplog, p2pb_records,
                                                    one_thread):
    from p2p_bridge_tpu_torch import train as train_module

    def broken(*args, **kwargs):
        raise ValueError("evaluation broke")

    monkeypatch.setattr(train_module, "evaluate", broken)
    synthetic_tree(tmp_path / "data")
    cfg = loop_cfg(tmp_path, "broken", "--training.viz_interval", "2", "--training.steps", "4")
    with caplog.at_level("WARNING", logger="p2pb"):
        state = train_module.train(cfg, "cpu")
    assert state.step == 4
    warned = [r.getMessage() for r in caplog.records if "Could not evaluate" in r.getMessage()]
    assert len(warned) == 2 and "evaluation broke" in warned[0]


def test_training_starts_no_wandb_where_the_config_says_so(tmp_path, monkeypatch, one_thread):
    """``use_wandb: false`` keeps train() from starting wandb, whose init
    reaches wandb's servers (and reports its errors to them); by default it
    starts, as the JAX package's tracker does. chip_smoke.py's training
    runs set it."""
    import sys
    import types

    import chip_smoke
    from p2p_bridge_tpu_torch import train as train_module

    started = []

    fake = types.ModuleType("wandb")
    fake.init = lambda **kwargs: started.append(kwargs["project"])
    fake.log = fake.Histogram = fake.Image = fake.finish = lambda *args, **kwargs: None
    monkeypatch.setitem(sys.modules, "wandb", fake)
    synthetic_tree(tmp_path / "data")
    cfg = loop_cfg(tmp_path, "quiet", "--training.steps", "1")
    cfg["use_wandb"] = False
    train_module.train(cfg, "cpu")
    assert started == []
    train_module.train(loop_cfg(tmp_path, "tracked", "--training.steps", "1"), "cpu")
    assert started == ["P2P-Bridge"]
    assert chip_smoke.train_config(tmp_path, tmp_path)["use_wandb"] is False
    assert chip_smoke.room_train_config(tmp_path, tmp_path, tmp_path)["use_wandb"] is False


def test_a_watch_step_updates_as_a_plain_step(tiny_pair):
    """return_grads hands back this step's gradients before the clip and
    changes nothing: the clipped gradients, the parameters, the moments and
    the EMA equal a plain step's from the same state and draws, bit for
    bit, and the returned gradients times the clip factor are the clipped
    ones."""
    import copy

    cfg, tmodel, _, _ = tiny_pair
    rng = np.random.default_rng(5)
    batch = {n: torch.tensor(v) for n, v in shuffled_batch(rng, 2, 256).items()}
    results = []
    for watch in (True, False):
        model = copy.deepcopy(tmodel)
        state = pts.init_train_state(model, cfg)
        bridge = P2PBridge.from_config(cfg, model)
        torch.manual_seed(3)
        m = pts.train_step(bridge, state, batch, torch.Generator().manual_seed(4),
                           grad_clip=1e-3, align_cfg=ALIGN, return_grads=watch)
        results.append((model, state, m))
    (wmodel, wstate, wm), (pmodel, pstate, pm) = results
    assert "grads" in wm and "grads" not in pm
    assert torch.equal(wm["loss"], pm["loss"]) and torch.equal(wm["grad_norm"], pm["grad_norm"])
    clip = torch.clamp(1e-3 / (wm["grad_norm"] + 1e-6), max=1.0)
    assert clip < 1.0
    for (name, a), b in zip(wmodel.named_parameters(), pmodel.parameters(), strict=True):
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad), name
        assert torch.equal(wm["grads"][name] * clip, b.grad), name
        assert not torch.equal(wm["grads"][name], b.grad) or not b.grad.any(), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(wstate.optimizer.state[a][key], pstate.optimizer.state[b][key])
    assert all(torch.equal(v, pstate.ema.params[k]) for k, v in wstate.ema.params.items())
