"""Checkpoints of the port (the torch counterpart of
p2p_bridge_tpu/models/model_loader.py's save and restore), and the
configuration and weights the denoising CLIs load.

A checkpoint is one ``torch.save`` dict {"model": state_dict, "ema":
state_dict of the EMA parameters or None, "optimizer": the optimizer's
state_dict, "schedule": the rate schedule's, "step": int}. Model and EMA
carry the reference torch ``state_dict`` keys (see weights.py), so
``load_weights`` loads either one directly (``use_ema`` picks the EMA).

A training run of the JAX package reaches the port as one ``.npz`` that
``export_jax_checkpoint.py`` writes where JAX runs (numpy arrays only, no
pickles; read with numpy). Its entries:

  format_version        int, FORMAT_VERSION
  step                  int, the training steps taken
  params/<flax path>    f32, the weights in flax layout, the path inside
                        the "params" collection joined by "/"
                        (e.g. params/sa0_conv0/vconv1/kernel)
  ema/<flax path>       f32, the EMA of the weights, where the run kept one
  opt/kind              str, "AdamW" or "Adam" (training.optimizer.type)
  opt/count             int, Adam's update count
  opt/mu/<flax path>    f32, Adam's first moment
  opt/nu/<flax path>    f32, Adam's second moment
  schedule/count        int, the rate schedule's update count, where the
                        schedule has one (StepLR, ExponentialLR)

The opt/ and schedule/ entries are absent where the checkpoint holds no
optimizer state. The EMA's own update count is not in a JAX checkpoint.
``opt.yaml`` (the run's configuration) is copied beside the file.
``restore_jax_checkpoint`` fills a TrainState from it, ``load_weights``
takes its params or EMA, and ``jax_checkpoint_arrays`` writes a port
TrainState in the same layout.
"""

from __future__ import annotations

import inspect
import logging
import os
import zipfile
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from ..parallel.train_step import TrainState
from ..utils.config import apply_dot_overrides, load_yaml
from ..weights import (flat_flax_arrays, flat_to_state_dict, flax_template, load_jax_params,
                       load_torch_state_dict, unflatten_params)

CHECKPOINT = "model.pt"
FORMAT_VERSION = 1
OPTIMIZERS = ("AdamW", "Adam")
logger = logging.getLogger("p2pb")


def load_config(model_path: str, overrides) -> dict:
    """opt.yaml in ``model_path`` when it is a directory, else beside the
    weights, else in their directory's parent, with ``--a.b value``
    overrides applied."""
    path = os.path.abspath(model_path)
    base = path if os.path.isdir(path) else os.path.dirname(path)
    for cand in (base, os.path.dirname(base)):
        path = os.path.join(cand, "opt.yaml")
        if os.path.exists(path):
            cfg = load_yaml(path)
            apply_dot_overrides(cfg, list(overrides))
            return cfg
    raise FileNotFoundError(f"opt.yaml not found near {model_path}")


def load_weights(model: torch.nn.Module, path: str, use_ema: bool) -> None:
    """The weights of ``path``: a file, or a run directory's model.pt. A
    reference torch state_dict (.pt/.pth, or a dict holding one under
    ``model`` / ``ema``), a JAX checkpoint exported by
    export_jax_checkpoint.py (.npz) or bare JAX params (.npz with flattened
    ``a/b/c`` keys). ``use_ema`` takes the EMA weights where the checkpoint
    has them, else the model's, as the JAX package's CLIs do."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT)
    if path.endswith(".npz"):
        arrays = _read_npz(path)
        if "format_version" not in arrays:  # bare params
            load_jax_params(model, unflatten_params(arrays))
            return
        ckpt = check_jax_checkpoint(arrays, path)
        part = "ema" if use_ema and _section(ckpt, "ema") else "params"
        model.load_state_dict(flat_to_state_dict(_section(ckpt, part), model), strict=True)
        return
    sd = torch.load(path, map_location="cpu", weights_only=True)
    key = "ema" if use_ema else "model"
    if use_ema and sd.get("ema") is None and isinstance(sd.get("model"), dict):
        key = "model"  # a checkpoint saved without EMA weights
    if isinstance(sd.get(key), dict):
        sd = sd[key]
    prefix = f"{key}."
    sd = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    load_torch_state_dict(model, sd)


def load_matched_weights(model: torch.nn.Module,
                         state_dict: Mapping[str, torch.Tensor]) -> Tuple[int, int]:
    """Partial load across configuration changes: copy every tensor of
    ``state_dict`` whose name and shape match one of the model's, keep the
    model's own values elsewhere, and warn on each tensor kept. Returns
    (n_loaded, n_skipped), counted over the model's tensors."""
    n_loaded = n_skipped = 0
    with torch.no_grad():
        for name, own in model.state_dict().items():
            old = state_dict.get(name)
            if old is not None and tuple(old.shape) == tuple(own.shape):
                own.copy_(old)
                n_loaded += 1
            else:
                n_skipped += 1
                logger.warning("Parameter %s %s; keeping fresh init.", name,
                               "not found in checkpoint" if old is None else "shape mismatch")
    return n_loaded, n_skipped


def save_checkpoint(path: str, state: TrainState) -> str:
    """Write ``state`` to ``path`` (a file, or a directory that gets
    ``model.pt``); returns the file."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT)
    ema = None
    if state.ema is not None:
        ema = {k: v.detach().cpu() for k, v in state.ema.params.items()}
    payload = {
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "ema": ema,
        "ema_step": None if state.ema is None else state.ema.step,
        "optimizer": state.optimizer.state_dict(),
        "schedule": state.schedule.state_dict(),
        "step": state.step,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    return path


def restore_checkpoint(path: str, state: TrainState, restart: bool = False) -> TrainState:
    """Load the model weights of ``path`` into ``state``; unless
    ``restart``, also the EMA, optimizer, schedule and step."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"], strict=True)
    if restart:
        return state
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.schedule.load_state_dict(ckpt["schedule"])
    state.step = int(ckpt["step"])
    if state.ema is not None and ckpt.get("ema") is not None:
        for name, e in state.ema.params.items():
            e.copy_(ckpt["ema"][name])
        state.ema.step = int(ckpt["ema_step"])
    return state


# ------------------------------------------------- exported JAX checkpoints
def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of the .npz ``path``, read now; a truncated or
    malformed file raises ValueError."""
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as e:
        raise ValueError(f"{path}: not a readable .npz ({e})") from e


def _section(arrays: Mapping[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    """The entries under ``name/``, the prefix stripped."""
    prefix = name + "/"
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _scalar(arrays: Mapping[str, np.ndarray], key: str, where: str) -> int:
    value = arrays[key]
    if value.shape != () or value.dtype.kind not in "iu":
        raise ValueError(f"{where}: {key} is not an integer scalar")
    return int(value)


def check_jax_checkpoint(arrays: Mapping[str, np.ndarray], where: str = "checkpoint"
                         ) -> Mapping[str, np.ndarray]:
    """``arrays`` if they hold a whole exported checkpoint (the layout of
    this module's docstring), else ValueError."""
    if "format_version" not in arrays:
        raise ValueError(f"{where}: no format_version; not an exported JAX checkpoint")
    version = _scalar(arrays, "format_version", where)
    if version != FORMAT_VERSION:
        raise ValueError(f"{where}: format_version {version}, this port reads {FORMAT_VERSION}")
    if "step" not in arrays:
        raise ValueError(f"{where}: no step")
    _scalar(arrays, "step", where)
    params = _section(arrays, "params")
    if not params:
        raise ValueError(f"{where}: no params/ entries")
    has_opt = any(k.startswith(("opt/", "schedule/")) for k in arrays)
    parts = ("ema", "opt/mu", "opt/nu") if has_opt else ("ema",)
    for name in parts:
        part = _section(arrays, name)
        if name == "ema" and not part:
            continue  # a run without an EMA
        if set(part) != set(params):
            raise ValueError(f"{where}: {name}/ holds {len(part)} entries, params/ {len(params)}")
        for k, v in part.items():
            if v.shape != params[k].shape:
                raise ValueError(f"{where}: shape of {name}/{k} {v.shape}, params {params[k].shape}")
    if has_opt:
        for key in ("opt/kind", "opt/count"):
            if key not in arrays:
                raise ValueError(f"{where}: optimizer state without {key}")
        kind = str(arrays["opt/kind"])
        if kind not in OPTIMIZERS:
            raise ValueError(f"{where}: opt/kind {kind!r}, not one of {OPTIMIZERS}")
        count = _scalar(arrays, "opt/count", where)
        if count != _scalar(arrays, "step", where):
            raise ValueError(f"{where}: step {int(arrays['step'])} but Adam's count {count}")
        if "schedule/count" in arrays and _scalar(arrays, "schedule/count", where) != count:
            raise ValueError(f"{where}: schedule/count {int(arrays['schedule/count'])} but "
                             f"Adam's count {count}")
    known = {"format_version", "step", "opt/kind", "opt/count", "schedule/count"}
    extra = [k for k in arrays if k not in known
             and not k.startswith(("params/", "ema/", "opt/mu/", "opt/nu/"))]
    if extra:
        raise ValueError(f"{where}: unknown entries {sorted(extra)[:8]}")
    return arrays


def read_jax_checkpoint(path: str) -> Mapping[str, np.ndarray]:
    """The arrays of an exported JAX checkpoint, checked whole."""
    return check_jax_checkpoint(_read_npz(path), path)


def _adam_step_like(optimizer: torch.optim.Optimizer, group: dict) -> torch.Tensor:
    """The "step" tensor torch's own first ``optimizer.step()`` makes for a
    parameter of ``group`` (its dtype and device follow the group's
    fused / capturable flags): one step of a same-class optimizer on one
    element on the group's device."""
    device = group["params"][0].device
    probe = torch.zeros(1, device=device, requires_grad=True)
    probe.grad = torch.zeros_like(probe)
    accepted = inspect.signature(type(optimizer)).parameters
    twin = type(optimizer)([probe], **{k: v for k, v in group.items()
                                       if k in accepted and k != "params"})
    twin.step()
    return twin.state[probe]["step"]


def restore_jax_checkpoint(source: Union[str, Mapping[str, np.ndarray]], state: TrainState,
                           restart: bool = False) -> TrainState:
    """Fill ``state`` from an exported JAX checkpoint (a path, or its
    arrays) as the JAX package's train.py resumes: the weights; unless
    ``restart``, also the step, the EMA's weights and Adam's state with the
    rate schedule. Returns ``state``.

    * The moments go through the weights' name map and transposes; each
      parameter's Adam state is {"step", "exp_avg", "exp_avg_sq"} with
      "step" of the dtype and device torch's own first step gives it.
    * The schedule stands at update ``count``: the group's rate is the base
      rate times the schedule's factor at ``count``, so the next update
      uses optax's ``learning_rate(count)``.
    * The EMA's update count restarts at 0, as JAX's resume keeps the fresh
      EMA's (its checkpoint holds no EMA count): the next 100 updates copy
      the parameters. A checkpoint without an EMA leaves the fresh one.
    * A checkpoint without optimizer state resumes the weights and the step
      with a fresh optimizer and schedule.
    """
    where = source if isinstance(source, str) else "checkpoint"
    arrays = (read_jax_checkpoint(source) if isinstance(source, str)
              else check_jax_checkpoint(source, where))
    model = state.model
    params = flat_to_state_dict(_section(arrays, "params"), model)
    ema = _section(arrays, "ema")
    ema = flat_to_state_dict(ema, model) if ema and state.ema is not None else None
    opt = None
    if not restart and "opt/kind" in arrays:
        kind = str(arrays["opt/kind"])
        if type(state.optimizer).__name__ != kind:
            raise ValueError(f"{where}: optimizer {kind}, the configuration's "
                             f"{type(state.optimizer).__name__}")
        opt = (int(arrays["opt/count"]), flat_to_state_dict(_section(arrays, "opt/mu"), model),
               flat_to_state_dict(_section(arrays, "opt/nu"), model))
    # everything is read and mapped: now change the state
    model.load_state_dict(params, strict=True)
    if restart:
        return state
    state.step = int(arrays["step"])
    if ema is not None:
        for name, e in state.ema.params.items():
            e.copy_(ema[name])
    if state.ema is not None:
        state.ema.step = 0
    if opt is not None:
        _load_adam(state, *opt)
    return state


def _load_adam(state: TrainState, count: int, mu: Mapping[str, torch.Tensor],
               nu: Mapping[str, torch.Tensor]) -> None:
    """Adam's state at update ``count`` with the moments ``mu`` / ``nu``
    (keyed like the model's parameters), and the schedule at ``count``."""
    optimizer, schedule = state.optimizer, state.schedule
    names = {p: n for n, p in state.model.named_parameters()}
    for group in optimizer.param_groups:
        like = _adam_step_like(optimizer, group)
        for p in group["params"]:
            name = names[p]
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=like.dtype, device=like.device),
                "exp_avg": mu[name].to(p.device), "exp_avg_sq": nu[name].to(p.device)}
    lrs = [base * fn(count) for base, fn in zip(schedule.base_lrs, schedule.lr_lambdas)]
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    sd = schedule.state_dict()
    sd.update(last_epoch=count, _step_count=count + 1, _last_lr=list(lrs))
    schedule.load_state_dict(sd)


def jax_checkpoint_arrays(state: TrainState, cfg: dict) -> Dict[str, np.ndarray]:
    """``state`` in the layout of an exported JAX checkpoint (what
    restore_jax_checkpoint reads back into the same state): the weights, the
    EMA's, Adam's moments and counts where the optimizer has stepped."""
    model = state.model
    template = flax_template(model)

    def flat(prefix: str, tensors) -> Dict[str, np.ndarray]:
        return {f"{prefix}/{k}": v for k, v in flat_flax_arrays(tensors, template).items()}

    out = {"format_version": np.asarray(FORMAT_VERSION, np.int32),
           "step": np.asarray(state.step, np.int32), **flat("params", model.state_dict())}
    if state.ema is not None:
        out.update(flat("ema", state.ema.params))
    named = dict(model.named_parameters())
    adam = [state.optimizer.state.get(p) for p in named.values()]
    if all(adam):
        counts = {int(s["step"]) for s in adam}
        if len(counts) != 1:
            raise ValueError(f"parameters at different Adam steps: {sorted(counts)}")
        count = counts.pop()
        out["opt/kind"] = np.asarray(type(state.optimizer).__name__)
        out["opt/count"] = np.asarray(count, np.int32)
        out.update(flat("opt/mu", {n: state.optimizer.state[p]["exp_avg"] for n, p in named.items()}))
        out.update(flat("opt/nu", {n: state.optimizer.state[p]["exp_avg_sq"]
                                   for n, p in named.items()}))
        # optax's state holds a schedule count for StepLR and ExponentialLR,
        # none for a constant rate
        if cfg["training"].get("scheduler", {}).get("type") in ("StepLR", "ExponentialLR"):
            out["schedule/count"] = np.asarray(state.schedule.last_epoch, np.int32)
    return out


def save_jax_checkpoint(path: str, arrays: Mapping[str, np.ndarray]) -> str:
    """Write the checked ``arrays`` to the .npz ``path`` (whole or not at
    all); returns ``path``."""
    check_jax_checkpoint(arrays, path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path
