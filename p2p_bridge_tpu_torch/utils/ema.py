"""Exponential moving average of the parameters (port of
p2p_bridge_tpu/utils/ema.py, itself ema_pytorch.EMA with the reference's
settings: beta 0.999, update_after_step 100, update_every 10, inv_gamma 1,
power 2/3).

Every update counts a step. For the first ``update_after_step`` steps the
EMA is a copy of the parameters; after that it moves every
``update_every`` steps with the warmed-up decay
clamp(1 - (1 + t / inv_gamma)^(-power), 0, beta), t the steps past the copy
phase: ema = ema * decay + param * (1 - decay), in that order, in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


@dataclass
class EmaState:
    params: Dict[str, torch.Tensor]  # name -> f32 copy, as named_parameters
    step: int = 0  # update() calls so far


def ema_init(params: Dict[str, torch.Tensor]) -> EmaState:
    return EmaState({k: v.detach().clone() for k, v in params.items()}, 0)


def ema_keep(step: int, beta: float = 0.999, update_after_step: int = 100,
             update_every: int = 10, inv_gamma: float = 1.0,
             power: float = 2.0 / 3.0) -> float:
    """The weight of the old EMA at update number ``step`` (1-based), as an
    f32 number: 0 in the copy phase, 1 between moves."""
    if step <= update_after_step:
        return 0.0
    if step % update_every:
        return 1.0
    t = np.float32(max(step - update_after_step - 1, 0))
    decay = np.float32(1.0) - (np.float32(1.0) + t / np.float32(inv_gamma)) ** np.float32(-power)
    return float(np.clip(decay, np.float32(0.0), np.float32(beta)))


@torch.no_grad()
def ema_update(state: EmaState, params: Dict[str, torch.Tensor], beta: float = 0.999,
               update_after_step: int = 100, update_every: int = 10,
               inv_gamma: float = 1.0, power: float = 2.0 / 3.0) -> EmaState:
    """One update, in place on ``state`` (which is returned), with
    multi-tensor kernels: ema * keep, then + param * (1 - keep)."""
    state.step += 1
    keep = ema_keep(state.step, beta, update_after_step, update_every, inv_gamma, power)
    if keep == 1.0:
        return state
    names = list(state.params)
    emas = [state.params[n] for n in names]
    rest = float(np.float32(1.0) - np.float32(keep))  # 1 - keep in f32, as in JAX
    moved = torch._foreach_mul([params[n].detach().to(emas[0].dtype) for n in names], rest)
    torch._foreach_mul_(emas, keep)
    torch._foreach_add_(emas, moved)
    return state
