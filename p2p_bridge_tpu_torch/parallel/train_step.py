"""The training step (port of p2p_bridge_tpu/parallel/train_step.py).

One step: the PUNet clean-to-noisy alignment (auction EMD, kernel K7 on the
card), ``accumulation_steps`` micro-batches of forward + backward (mean
loss, mean gradients), the global-norm clip min(1, clip / (|g| + 1e-6)),
the optimizer step and the EMA update. The optimizer follows optax's
``make_optimizer``: AdamW (decoupled decay), or Adam with the decay added to
the gradient (optax ``add_decayed_weights`` before ``adam``), with a
constant, StepLR (x0.9 every 10,000 steps, staircase) or ExponentialLR
(per step) rate that gives optax's ``learning_rate(count)`` at update
number ``count``. bf16 compute keeps f32 parameters and needs no loss
scaling, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..metrics.emd_auction import align_clean_to_noisy
from ..utils.ema import EmaState, ema_init, ema_update


def learning_rate_factor(cfg: dict) -> Callable[[int], float]:
    """count -> lr / base lr of the configured schedule."""
    sched = cfg["training"].get("scheduler", {})
    kind = sched.get("type", "constant")
    if kind == "ExponentialLR":
        gamma = float(sched["lr_gamma"])
        return lambda count: gamma ** count
    if kind == "StepLR":
        # torch StepLR(step_size=10_000, gamma=0.9) (reference model_loader.py:50)
        return lambda count: 0.9 ** (count // 10_000)
    return lambda count: 1.0


def make_optimizer(cfg: dict, params):
    """(optimizer, LambdaLR schedule) for ``params`` from
    ``training.optimizer`` and ``training.scheduler``."""
    opt = cfg["training"]["optimizer"]
    kind = opt.get("type", "AdamW")
    kwargs = dict(lr=float(opt["lr"]),
                  betas=(float(opt.get("beta1", 0.9)), float(opt.get("beta2", 0.999))),
                  eps=1e-8, weight_decay=float(opt.get("weight_decay", 0.0)))
    if kind == "AdamW":
        optimizer = torch.optim.AdamW(params, **kwargs)
    elif kind == "Adam":  # weight decay added to the gradient (L2)
        optimizer = torch.optim.Adam(params, **kwargs)
    else:
        raise NotImplementedError(kind)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, learning_rate_factor(cfg))


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LRScheduler
    ema: Optional[EmaState]
    step: int = 0


def init_train_state(model: nn.Module, cfg: dict, use_ema: bool = True) -> TrainState:
    optimizer, schedule = make_optimizer(cfg, model.parameters())
    ema = ema_init(dict(model.named_parameters())) if use_ema else None
    return TrainState(model, optimizer, schedule, ema, 0)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (f32 tensors), from one
    multi-tensor norm launch per group instead of two kernels per tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def train_step(bridge, state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               grad_clip: Optional[float] = 1.0, accumulation_steps: int = 1,
               ema_decay: float = 0.999, align_cfg: Optional[dict] = None,
               steps: Optional[torch.Tensor] = None,
               mark: Optional[Callable[[str], None]] = None,
               return_grads: bool = False) -> Dict[str, torch.Tensor]:
    """One update of ``state`` (in place) from ``batch`` = {"x_gt",
    "x_start"[, "x_cond"]}, each [accumulation_steps * B, N, C] on the
    model's device. ``steps`` (the diffusion timesteps of every cloud, in
    batch order) are drawn from ``generator`` when not given; ``mark`` is
    called with "align", "forward_backward" and "update" as each phase has
    been issued. Returns {"loss", "grad_norm" (before the clip),
    "param_norm" (after the update)} as 0-d tensors; with
    ``return_grads`` also "grads", {name: a copy of the parameter's
    gradient before the clip}, taken from this step's backward (the
    update is the same, bit for bit)."""
    model = state.model
    model.train()
    if align_cfg is not None:
        batch = dict(batch, x_gt=align_clean_to_noisy(
            batch["x_start"], batch["x_gt"], eps=align_cfg.get("eps", 0.01),
            iters=align_cfg.get("iters", 100)))
    if mark:
        mark("align")

    params = [p for p in model.parameters() if p.requires_grad]
    state.optimizer.zero_grad(set_to_none=True)
    total = batch["x_start"].shape[0]
    micro = total // accumulation_steps
    loss_sum = 0.0
    for k in range(accumulation_steps):
        part = slice(k * micro, (k + 1) * micro)
        loss = bridge.loss_fn(batch["x_gt"][part], batch["x_start"][part],
                              None if batch.get("x_cond") is None else batch["x_cond"][part],
                              generator=generator,
                              steps=None if steps is None else steps[part])
        loss.backward()
        loss_sum = loss_sum + loss.detach()
    loss = loss_sum / accumulation_steps
    for p in params:
        if p.grad is None:  # unused this step: a zero gradient, as in JAX
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if accumulation_steps > 1:
        torch._foreach_div_(grads, accumulation_steps)
    grad_norm = global_norm(grads)
    raw_grads = None
    if return_grads:
        raw_grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                     if p.requires_grad}
    if mark:
        mark("forward_backward")

    if grad_clip is not None:
        torch._foreach_mul_(grads, torch.clamp(grad_clip / (grad_norm + 1e-6), max=1.0))
    state.optimizer.step()
    state.schedule.step()
    if state.ema is not None:
        ema_update(state.ema, dict(model.named_parameters()), beta=ema_decay)
    state.step += 1
    with torch.no_grad():
        param_norm = global_norm(model.parameters())
    if mark:
        mark("update")
    out = {"loss": loss, "grad_norm": grad_norm, "param_norm": param_norm}
    if raw_grads is not None:
        out["grads"] = raw_grads
    return out
