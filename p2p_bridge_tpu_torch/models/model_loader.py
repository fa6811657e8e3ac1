"""Checkpoints of the port (the torch counterpart of
p2p_bridge_tpu/models/model_loader.py's save and restore).

A checkpoint is one ``torch.save`` dict {"model": state_dict, "ema":
state_dict of the EMA parameters or None, "optimizer": the optimizer's
state_dict, "schedule": the rate schedule's, "step": int}. Model and EMA
carry the reference torch ``state_dict`` keys (see weights.py), so
``denoise_object`` loads either one directly (``--use_ema`` picks the EMA).
"""

from __future__ import annotations

import os

import torch

from ..parallel.train_step import TrainState

CHECKPOINT = "model.pt"


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
