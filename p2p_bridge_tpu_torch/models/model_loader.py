"""Checkpoints of the port (the torch counterpart of
p2p_bridge_tpu/models/model_loader.py's save and restore), and the
configuration and weights the denoising CLIs load.

A checkpoint is one ``torch.save`` dict {"model": state_dict, "ema":
state_dict of the EMA parameters or None, "optimizer": the optimizer's
state_dict, "schedule": the rate schedule's, "step": int}. Model and EMA
carry the reference torch ``state_dict`` keys (see weights.py), so
``load_weights`` loads either one directly (``use_ema`` picks the EMA).
"""

from __future__ import annotations

import logging
import os
from typing import Mapping, Tuple

import torch

from ..parallel.train_step import TrainState
from ..utils.config import apply_dot_overrides, load_yaml
from ..weights import load_jax_params, load_npz, load_torch_state_dict

CHECKPOINT = "model.pt"
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
    ``model`` / ``ema``) or JAX params (.npz). ``use_ema`` takes the EMA
    weights where the checkpoint has them, else the model's, as the JAX
    package's CLIs do."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT)
    if path.endswith(".npz"):
        load_jax_params(model, load_npz(path))
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
