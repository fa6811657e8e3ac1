"""A training run of the JAX package carried to the port: the JAX package
saves it with its own ``save_checkpoint``, export_jax_checkpoint.py writes
the numpy file, and the port's ``restore_jax_checkpoint`` / ``load_weights``
/ training CLI read it; on the CPU, at TINY widths."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import (ALIGN, LR, ROOT, TINY_OVERRIDES, assert_step_matches,
                              jax_step_draws, jax_tree, one_thread, optimizer_cfg, shuffled_batch,
                              synthetic_tree, tiny_pair)

import export_jax_checkpoint as exporter
from p2p_bridge_tpu.models import model_loader as jax_loader
from p2p_bridge_tpu.models.p2pb import P2PBridge as JaxBridge
from p2p_bridge_tpu.parallel import train_step as jts
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu_torch.models import model_loader
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config
from p2p_bridge_tpu_torch.parallel import train_step as pts

assert tiny_pair and one_thread  # fixtures of tests/test_torch_train.py, shared here


def optax_rate(scheduler: str, lr: float = LR, gamma: float = 0.99):
    """optax's learning_rate(count) of make_optimizer's schedules."""
    return {"constant": lambda c: lr,
            "StepLR": optax.exponential_decay(lr, 10_000, 0.9, staircase=True),
            "ExponentialLR": optax.exponential_decay(lr, 1, gamma)}[scheduler]


def save_run(run: Path, cfg: dict, step: int, params, ema=None, opt_state=None) -> Path:
    """A run directory as the JAX package's train.py writes it: opt.yaml
    (Config.save) and step_<step> (save_checkpoint)."""
    run.mkdir(parents=True, exist_ok=True)
    Config(cfg).save(str(run / "opt.yaml"))
    jax_loader.save_checkpoint(str(run), step, params, ema, opt_state)
    return run


def port_state(cfg: dict):
    model = build_unet_from_config(cfg)
    return model, pts.init_train_state(model, cfg)


def as_numpy(tensors) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def assert_tree_equal(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def moments(state, model, key: str) -> dict:
    return {n: state.optimizer.state[p][key].numpy() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def jax_run(tiny_pair, tmp_path_factory):
    """Three JAX train steps (AdamW, EMA, clip, alignment) from the TINY
    weights, saved as step_3 of a run directory; the jitted step, its key
    and the batch stream's generator go on to the resumed step."""
    cfg, _, fmodel, variables = tiny_pair
    fb = JaxBridge.from_config(Config(cfg), fmodel)
    opt = jts.make_optimizer(Config(cfg))
    step = jax.jit(jts.make_train_step(fb, opt, grad_clip=1.0, align_cfg=ALIGN,
                                       return_grads=True))
    jstate = jts.init_train_state(variables, opt, use_ema=True)
    key = jax.random.key(0)
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = shuffled_batch(rng, 2, 256)
        jstate, _ = step(jstate, key, {n: jnp.asarray(v) for n, v in batch.items()})
    run = save_run(tmp_path_factory.mktemp("jax") / "run", cfg, 3, jstate.params,
                   jstate.ema.params, jstate.opt_state)
    out = run.parent / "export" / "run.npz"
    exporter.main([str(run), "--out", str(out)])
    return {"cfg": cfg, "bridge": fb, "opt": opt, "step": step, "state": jstate, "key": key,
            "rng": rng, "run": run, "npz": out}


def test_export_and_import_equal_the_jax_state(jax_run):
    """Params, EMA, Adam's moments, the counts and the step as JAX saved
    them; the rate is optax's at the count; the EMA's count restarts."""
    cfg, jstate = jax_run["cfg"], jax_run["state"]
    model, state = port_state(cfg)
    model_loader.restore_jax_checkpoint(str(jax_run["npz"]), state)
    assert_tree_equal(as_numpy(model.state_dict()), jax_tree(jstate.params, model), "params")
    assert_tree_equal(as_numpy(state.ema.params), jax_tree(jstate.ema.params, model), "ema")
    adam = jstate.opt_state[0]
    assert_tree_equal(moments(state, model, "exp_avg"), jax_tree(adam.mu, model), "mu")
    assert_tree_equal(moments(state, model, "exp_avg_sq"), jax_tree(adam.nu, model), "nu")
    assert state.step == int(jstate.step) == int(adam.count) == 3
    assert all(int(s["step"]) == 3 for s in state.optimizer.state.values())
    assert state.schedule.last_epoch == 3
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(optax_rate("constant")(3)), rel=1e-7)
    assert state.ema.step == 0 and int(jstate.ema.step) == 3
    # opt.yaml beside the file, read by the port's YAML reader as JAX wrote it
    assert model_loader.load_config(str(jax_run["npz"]), []) == \
        Config.load(str(jax_run["run"] / "opt.yaml")).to_dict()
    assert exporter.FORMAT_VERSION == model_loader.FORMAT_VERSION


def test_a_resumed_step_matches_jax(jax_run):
    """One step from the checkpoint in each package, JAX resuming as its
    train.py does (typed restore, the fresh EMA's count): the loss, the
    norms, the gradients, the moments, the parameters and the EMA (its copy
    phase) within tests/test_torch_train.py's tolerances."""
    cfg, fb, opt = jax_run["cfg"], jax_run["bridge"], jax_run["opt"]
    template = jax_run["state"].params
    fresh = jts.init_train_state(template, opt, use_ema=True)
    ckpt = jax_loader.restore_checkpoint(str(jax_run["run"]), params_template=template,
                                         opt_state_template=opt.init(template))
    jstate = fresh._replace(params=ckpt["params"], opt_state=ckpt["opt_state"],
                            ema=fresh.ema._replace(params=ckpt["ema"]),
                            step=jnp.int32(int(ckpt["step"])))
    # the same values, uncommitted to a device as the jitted step's own
    # outputs are, so the step that took the three steps runs uncompiled
    jstate = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), jstate)
    model, state = port_state(cfg)
    model_loader.restore_jax_checkpoint(str(jax_run["npz"]), state)
    batch = shuffled_batch(jax_run["rng"], 2, 256)
    steps = jax_step_draws(fb, jax_run["key"], 3, 2)
    jstate, m = jax_run["step"](jstate, jax_run["key"],
                                {n: jnp.asarray(v) for n, v in batch.items()})
    got = pts.train_step(P2PBridge.from_config(cfg, model), state,
                         {n: torch.tensor(v) for n, v in batch.items()}, grad_clip=1.0,
                         align_cfg=ALIGN, steps=torch.tensor(steps))
    assert_step_matches(got, m, jstate, state, model, 3)
    assert state.ema.step == int(jstate.ema.step) == 1
    assert all(torch.equal(state.ema.params[n], p) for n, p in model.named_parameters())


def with_count(opt_state, kind: str, count: int):
    """``opt_state`` of make_optimizer with Adam's count, and the schedule's
    where it has one, set to ``count``."""
    def bump(part):
        return part._replace(count=jnp.asarray(count, jnp.int32)) if "count" in getattr(part, "_fields", ()) else part

    if kind == "AdamW":
        return tuple(bump(part) for part in opt_state)
    decay, (adam, rate) = opt_state
    return (decay, (bump(adam), bump(rate)))


@pytest.fixture
def fixed_init(monkeypatch, tiny_pair):
    """The exporter's restore template without its jitted flax init: a
    typed restore reads only the template's tree, shapes and dtypes, which
    the TINY variables share (the unpatched export runs in jax_run)."""
    variables = tiny_pair[3]
    monkeypatch.setattr(jax_loader, "init_params", lambda cfg, model, seed=0: variables)
    return variables


# the count each schedule is read at: past StepLR's first stair, and where
# ExponentialLR's f32 rate is still a normal number
COUNTS = {"constant": 10_003, "StepLR": 10_003, "ExponentialLR": 103}


@pytest.mark.parametrize("scheduler", ["constant", "StepLR", "ExponentialLR"])
@pytest.mark.parametrize("kind", ["AdamW", "Adam"])
def test_optimizer_layouts_import_whole(kind, scheduler, tiny_pair, fixed_init, tmp_path):
    """AdamW (optax.adamw) and Adam (add_decayed_weights, then adam) under
    each schedule: an opt_state from three eager optax updates of the TINY
    params, counts moved to COUNTS, saved, exported and imported: params,
    EMA, moments, counts, step and optax's rate at the count."""
    cfg = dict(tiny_pair[0], training=optimizer_cfg(kind, scheduler)["training"])
    opt = jts.make_optimizer(Config(cfg))
    params = fixed_init
    opt_state = opt.init(params)
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
                             params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    count = COUNTS[scheduler]
    opt_state = with_count(opt_state, kind, count)
    ema = jax.tree.map(lambda a: a * 0.5, params)
    run = save_run(tmp_path / "run", cfg, count, params, ema, opt_state)
    exporter.main([str(run), "--out", str(tmp_path / "run.npz")])
    arrays = model_loader.read_jax_checkpoint(str(tmp_path / "run.npz"))
    assert str(arrays["opt/kind"]) == kind
    assert ("schedule/count" in arrays) == (scheduler != "constant")

    model, state = port_state(cfg)
    model_loader.restore_jax_checkpoint(str(tmp_path / "run.npz"), state)
    adam = opt_state[0] if kind == "AdamW" else opt_state[-1][0]
    assert type(state.optimizer).__name__ == kind
    assert_tree_equal(as_numpy(model.state_dict()), jax_tree(params, model), "params")
    assert_tree_equal(as_numpy(state.ema.params), jax_tree(ema, model), "ema")
    assert_tree_equal(moments(state, model, "exp_avg"), jax_tree(adam.mu, model), "mu")
    assert_tree_equal(moments(state, model, "exp_avg_sq"), jax_tree(adam.nu, model), "nu")
    assert state.step == state.schedule.last_epoch == count
    assert {float(s["step"]) for s in state.optimizer.state.values()} == {float(count)}
    # optax's rate is f32 (gamma ** count rounded on the way), the port's
    # f64: tests/test_torch_train.py's rtol for the schedules
    want = float(optax_rate(scheduler)(count))
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(want, rel=1e-5)
    assert state.schedule.get_last_lr() == [state.optimizer.param_groups[0]["lr"]]


def test_the_exporter_refuses_an_unknown_optimizer_layout():
    with pytest.raises(ValueError, match="optimizer 'SGD'"):
        exporter.adam_and_schedule((), "SGD")
    sgd = optax.sgd(0.1).init({"w": jnp.zeros(2)})
    for kind in ("AdamW", "Adam"):
        with pytest.raises(ValueError, match=f"unexpected {kind} state layout"):
            exporter.adam_and_schedule(sgd, kind)


def fresh_copy(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}, \
        {k: v.clone() for k, v in state.ema.params.items()}


def test_run_directories_and_choices(tiny_pair, fixed_init, tmp_path, caplog):
    """The exporter takes a run directory's latest step_N, or the step
    named; use_ema picks ema/ or params/; a run saved without an EMA, one
    without optimizer state and restart=True resume as the JAX package's
    train.py does; a truncated or partial file raises and changes nothing."""
    cfg, params = tiny_pair[0], fixed_init
    opt = jts.make_optimizer(Config(cfg))
    doubled = jax.tree.map(lambda a: a * 2.0, params)
    halved = jax.tree.map(lambda a: a * 0.5, params)
    run = save_run(tmp_path / "run", cfg, 1, params, halved, with_count(opt.init(params), "AdamW", 1))
    jax_loader.save_checkpoint(str(run), 5, doubled, params,
                               with_count(opt.init(params), "AdamW", 5))
    exporter.main([str(run), "--out", str(tmp_path / "latest.npz")])
    exporter.main([str(run / "step_1"), "--out", str(tmp_path / "first" / "step1.npz")])
    assert int(np.load(tmp_path / "latest.npz")["step"]) == 5
    assert int(np.load(tmp_path / "first" / "step1.npz")["step"]) == 1
    assert (tmp_path / "first" / "opt.yaml").read_text() == (run / "opt.yaml").read_text()

    for use_ema, want in ((True, halved), (False, params)):
        model = build_unet_from_config(cfg)
        model_loader.load_weights(model, str(tmp_path / "first" / "step1.npz"), use_ema)
        assert_tree_equal(as_numpy(model.state_dict()), jax_tree(want, model), f"ema {use_ema}")

    # no EMA in the checkpoint: use_ema takes the params; the fresh EMA stays
    save_run(tmp_path / "no_ema", cfg, 2, doubled, None, with_count(opt.init(params), "AdamW", 2))
    exporter.main([str(tmp_path / "no_ema"), "--out", str(tmp_path / "no_ema.npz")])
    assert not model_loader._section(np.load(tmp_path / "no_ema.npz"), "ema")
    model = build_unet_from_config(cfg)
    model_loader.load_weights(model, str(tmp_path / "no_ema.npz"), True)
    assert_tree_equal(as_numpy(model.state_dict()), jax_tree(doubled, model), "no ema")
    model, state = port_state(cfg)
    _, ema_before = fresh_copy(state)
    model_loader.restore_jax_checkpoint(str(tmp_path / "no_ema.npz"), state)
    assert state.step == 2 and state.ema.step == 0 and state.schedule.last_epoch == 2
    assert all(torch.equal(v, ema_before[k]) for k, v in state.ema.params.items())

    # no optimizer state: the weights, the EMA and the step, a fresh optimizer
    save_run(tmp_path / "no_opt", cfg, 4, doubled, halved)
    exporter.main([str(tmp_path / "no_opt"), "--out", str(tmp_path / "no_opt.npz")])
    model, state = port_state(cfg)
    model_loader.restore_jax_checkpoint(str(tmp_path / "no_opt.npz"), state)
    assert state.step == 4 and not state.optimizer.state and state.schedule.last_epoch == 0
    assert state.optimizer.param_groups[0]["lr"] == LR
    assert_tree_equal(as_numpy(state.ema.params), jax_tree(halved, model), "no opt ema")

    # restart: the weights alone
    model, state = port_state(cfg)
    _, ema_before = fresh_copy(state)
    model_loader.restore_jax_checkpoint(str(tmp_path / "latest.npz"), state, restart=True)
    assert_tree_equal(as_numpy(model.state_dict()), jax_tree(doubled, model), "restart")
    assert state.step == 0 and not state.optimizer.state and state.schedule.last_epoch == 0
    assert all(torch.equal(v, ema_before[k]) for k, v in state.ema.params.items())

    # a truncated file and a partial one raise before anything is loaded
    data = (tmp_path / "latest.npz").read_bytes()
    (tmp_path / "cut.npz").write_bytes(data[: len(data) // 2])
    arrays = dict(np.load(tmp_path / "latest.npz"))
    partial = dict(arrays)
    partial.pop(next(k for k in arrays if k.startswith("opt/nu/")))
    np.savez(tmp_path / "partial.npz", **partial)
    wrong_count = dict(arrays, step=np.asarray(4, np.int32))
    np.savez(tmp_path / "count.npz", **wrong_count)
    for name, match in (("cut", "not a readable"), ("partial", "opt/nu/ holds"),
                        ("count", "Adam's count 5")):
        model, state = port_state(cfg)
        before, _ = fresh_copy(state)
        with pytest.raises(ValueError, match=match):
            model_loader.restore_jax_checkpoint(str(tmp_path / f"{name}.npz"), state)
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
        assert state.step == 0 and not state.optimizer.state
    with pytest.raises(ValueError, match="not a readable"):
        model_loader.load_weights(build_unet_from_config(cfg), str(tmp_path / "cut.npz"), False)
    adam_cfg = dict(cfg, training=optimizer_cfg("Adam")["training"])
    with pytest.raises(ValueError, match="optimizer AdamW, the configuration's Adam"):
        model_loader.restore_jax_checkpoint(str(tmp_path / "latest.npz"), port_state(adam_cfg)[1])


def test_port_state_round_trip_is_bit_equal(jax_run, tmp_path):
    """A port TrainState after two steps (ExponentialLR) -> the exported
    layout (the same names as the JAX export's) -> a fresh TrainState:
    weights, EMA, moments, Adam's step tensors, schedule and step equal
    bit for bit; the EMA's count restarts, as a JAX import's does."""
    cfg = dict(jax_run["cfg"], training=optimizer_cfg("AdamW", "ExponentialLR")["training"])
    model, state = port_state(cfg)
    bridge = P2PBridge.from_config(cfg, model)
    rng = np.random.default_rng(9)
    for _ in range(2):
        batch = {n: torch.tensor(v) for n, v in shuffled_batch(rng, 2, 256).items()}
        pts.train_step(bridge, state, batch, torch.Generator().manual_seed(1), grad_clip=1.0,
                       align_cfg=ALIGN)
    arrays = model_loader.jax_checkpoint_arrays(state, cfg)
    exported = np.load(jax_run["npz"])
    assert set(arrays) == set(exported.files) | {"schedule/count"}
    assert all(arrays[k].shape == exported[k].shape for k in exported.files)
    path = model_loader.save_jax_checkpoint(str(tmp_path / "port.npz"), arrays)

    model2, state2 = port_state(cfg)
    model_loader.restore_jax_checkpoint(path, state2)
    for (name, p), q in zip(model.named_parameters(), model2.parameters(), strict=True):
        assert torch.equal(p, q), name
        assert torch.equal(state.ema.params[name], state2.ema.params[name]), name
        a, b = state.optimizer.state[p], state2.optimizer.state[q]
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]) and a[key].dtype == b[key].dtype, (name, key)
            assert a[key].device == b[key].device, (name, key)
    drop = ("lr_lambdas",)
    assert {k: v for k, v in state.schedule.state_dict().items() if k not in drop} == \
        {k: v for k, v in state2.schedule.state_dict().items() if k not in drop}
    assert state.optimizer.param_groups[0]["lr"] == state2.optimizer.param_groups[0]["lr"]
    assert state2.step == state.step == 2 and state.ema.step == 2 and state2.ema.step == 0


def cli_argv(tmp_path, name, *extra):
    """The training CLI's flags for PVDS_PUNet at TINY widths on the
    synthetic tree, in exact epochs."""
    return ["--config", str(ROOT / "configs" / "PVDS_PUNet.yaml"),
            "--save_dir", str(tmp_path / "runs"), "--name", name,
            "--data.data_dir", str(tmp_path / "data"), "--data.loader", "epoch",
            "--training.log_interval", "1", "--training.save_interval", "1000",
            *TINY_OVERRIDES, *extra]


def test_the_clis_take_the_file(tmp_path, one_thread):
    """The training CLI resumes from the exported layout exactly as from
    model.pt (same seed and epochs): the parameters and moments of the
    resumed step bit-equal, the file's EMA in its copy phase; denoise_object
    reads the file with --use_ema."""
    from p2p_bridge_tpu_torch import denoise_object
    from p2p_bridge_tpu_torch import train as train_cli
    from p2p_bridge_tpu_torch.utils.args import parse_args
    from p2p_bridge_tpu_torch.utils.io import read_xyz, write_xyz

    synthetic_tree(tmp_path / "data")
    first_cfg = parse_args(cli_argv(tmp_path, "first", "--training.steps", "2"))
    first = train_cli.train(first_cfg, "cpu")
    run = Path(first_cfg["output_dir"])
    export = tmp_path / "export"
    export.mkdir()
    train_cli.write_run_config(dict(first_cfg, output_dir=str(export)))
    npz = model_loader.save_jax_checkpoint(
        str(export / "run.npz"), model_loader.jax_checkpoint_arrays(first, first_cfg))
    resumed = {}
    for name, path in (("npz", npz), ("pt", str(run / "model.pt"))):
        resumed[name] = train_cli.main(cli_argv(
            tmp_path, name, "--model_path", path, "--training.steps", "3", "--device", "cpu"))
    a, b = resumed["npz"], resumed["pt"]
    assert a.step == b.step == 3 and a.ema.step == 1 and b.ema.step == 3
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters(), strict=True):
        assert torch.equal(p, q), name
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[p][key], b.optimizer.state[q][key]), (name, key)
        assert torch.equal(a.ema.params[name], p), name

    cloud = tmp_path / "cloud.xyz"
    write_xyz(str(cloud), np.random.default_rng(1).normal(size=(600, 3)).astype(np.float32))
    out = denoise_object.main(["--data_path", str(cloud), "--model_path", npz, "--device", "cpu",
                               "--use_ema", "--steps", "2", "--recombine", "bucketed"])
    pts_out = read_xyz(out)
    assert pts_out.shape == (600, 3) and np.isfinite(pts_out).all()
