"""P2PBridge, the diffusion Schroedinger-bridge runtime (port of
p2p_bridge_tpu/models/p2pb.py).

The schedule and the per-step sampler coefficients are numpy
(``schedules.BridgeSchedule`` / ``SamplerPlan``); ``sample`` is a Python
loop over the plan with one backbone forward per step; ``loss_fn`` is the
training loss. The sampler state stays f32 whatever the backbone computes
in. x0 is the clean cloud, x1 the noisy one. Tensors are [B, N, C].
Random draws (timesteps, noise) come from a ``torch.Generator`` on the
tensors' device; dropout, in train mode, from the device's global RNG.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from .loss import get_loss
from .schedules import BridgeSchedule, space_indices


def _coef(values, steps: torch.Tensor) -> torch.Tensor:
    """values[steps] as [B, 1, 1] f32 on the device of ``steps``."""
    return torch.as_tensor(values, device=steps.device)[steps][:, None, None]


@dataclass
class P2PBridge:
    model: nn.Module
    schedule: BridgeSchedule
    ot_ode: bool = True
    cond_x1: bool = False
    add_x1_noise: bool = False
    objective: str = "pred_noise"
    weight_loss: bool = False
    loss_multiplier: float = 1.0
    loss_type: str = "mse"
    sampling_timesteps: int = 10

    @classmethod
    def from_config(cls, cfg, model: nn.Module) -> "P2PBridge":
        d = cfg["diffusion"]
        schedule = BridgeSchedule.create(
            timesteps=d["timesteps"], beta_start=d["beta_start"],
            beta_end=d["beta_end"], t0=d["t0"], T=d["T"],
            symmetric=d.get("symmetric", True),
            objective=d.get("objective", "pred_noise"),
            snr_clip=d.get("snr_clip", False))
        return cls(
            model=model, schedule=schedule, ot_ode=d.get("ot_ode", True),
            cond_x1=d.get("cond_x1", False), add_x1_noise=d.get("add_x1_noise", False),
            objective=d.get("objective", "pred_noise"),
            weight_loss=d.get("weight_loss", False),
            loss_multiplier=d.get("loss_multiplier", 1.0),
            loss_type=d.get("loss_type", "mse"),
            sampling_timesteps=d.get("sampling_timesteps", 10))

    def q_sample(self, steps: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Bridge interpolation q(x_t | x0, x1); adds noise unless ot_ode."""
        s = self.schedule
        xt = _coef(s.mu_x0, steps) * x0 + _coef(s.mu_x1, steps) * x1
        if not self.ot_ode:
            noise = torch.randn(xt.shape, generator=generator, device=xt.device,
                                dtype=xt.dtype)
            xt = xt + _coef(s.std_sb, steps) * noise
        return xt.detach()

    def compute_gt(self, steps: torch.Tensor, x0: torch.Tensor,
                   xt: torch.Tensor) -> torch.Tensor:
        """The network's regression target."""
        if self.objective == "pred_noise":
            return ((xt - x0) / _coef(self.schedule.std_fwd, steps)).detach()
        return x0.detach()

    def loss_fn(self, x0: torch.Tensor, x1: torch.Tensor,
                x_cond: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                steps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training loss (scalar) of the clean x0 and noisy x1 [B, N, 3].

        ``steps`` [B] (timestep indices) are drawn from ``generator``
        uniformly in [0, timesteps) when not given; then the x1 noise
        (``add_x1_noise``) and the bridge noise (unless ``ot_ode``). The
        backbone runs as the caller set it (``model.train()`` for dropout)."""
        B = x0.shape[0]
        dev = x0.device
        if steps is None:
            steps = torch.randint(0, self.schedule.timesteps, (B,), generator=generator,
                                  device=dev)
        steps = steps.to(dev).long()
        if self.add_x1_noise:
            x1 = x1 + torch.randn(x1.shape, generator=generator, device=dev, dtype=x1.dtype)
        xt = self.q_sample(steps, x0, x1, generator)
        gt = self.compute_gt(steps, x0, xt)
        cond = x_cond
        if self.cond_x1:
            cond = x1 if x_cond is None else torch.cat([x1, x_cond], dim=-1)
        noise_levels = torch.as_tensor(self.schedule.noise_levels, device=dev)[steps]
        pred = self.model(xt, noise_levels, cond)
        loss = get_loss(self.loss_type)(pred, gt)
        if self.weight_loss:
            loss = loss * torch.as_tensor(self.schedule.loss_weight, device=dev)[steps]
        return loss.mean() * self.loss_multiplier

    @staticmethod
    def pred_x0_from_eps(std_fwd, xt: torch.Tensor, net_out: torch.Tensor,
                         clip_denoise: bool = False) -> torch.Tensor:
        x0 = xt - std_fwd * net_out
        return x0.clamp(-3.0, 3.0) if clip_denoise else x0

    @torch.no_grad()
    def sample(self, x_start: torch.Tensor, x_cond: Optional[torch.Tensor] = None,
               steps: Optional[int] = None, clip_denoise: bool = False,
               generator: Optional[torch.Generator] = None,
               log_count: int = 10) -> Dict[str, torch.Tensor]:
        """Reverse bridge sampling from x_start = x1 [B, N, 3].

        Returns {"x_chain": [B, L, N, 3] states in backward order (index 0
        the final one), spaced over the chain by space_indices; "pred_chain"
        likewise for the x0 predictions; "x_pred": [B, N, 3]; "x_start"}.
        ``generator`` supplies the noise when ot_ode is false or
        add_x1_noise is set."""
        plan = self.schedule.sampler_plan(steps or self.sampling_timesteps)
        x1 = x_start
        if self.add_x1_noise:
            x1 = x1 + torch.randn(x1.shape, generator=generator, device=x1.device,
                                  dtype=x1.dtype)
        cond = x_cond
        if self.cond_x1:
            cond = x1 if x_cond is None else torch.cat([x1, x_cond], dim=-1)

        B = x1.shape[0]
        xt = x1
        xs, preds = [], []
        for i in range(plan.num_steps):
            nl = torch.full((B,), float(plan.noise_level_n[i]), device=xt.device)
            net_out = self.model(xt, nl, cond)
            if self.objective == "pred_noise":
                pred_x0 = self.pred_x0_from_eps(float(plan.std_fwd_n[i]), xt, net_out,
                                                clip_denoise)
            else:
                pred_x0 = net_out
            xt = float(plan.post_mu_x0[i]) * pred_x0 + float(plan.post_mu_xn[i]) * xt
            if not self.ot_ode:
                noise = torch.randn(xt.shape, generator=generator, device=xt.device,
                                    dtype=xt.dtype)
                xt = xt + float(plan.noise_mask[i] * plan.post_std[i]) * noise
            xs.append(xt)
            preds.append(pred_x0)

        log_idx = space_indices(plan.num_steps, min(log_count, plan.num_steps))
        x_chain = torch.stack(xs[::-1], dim=1)[:, log_idx]
        pred_chain = torch.stack(preds[::-1], dim=1)[:, log_idx]
        return {"x_chain": x_chain, "pred_chain": pred_chain, "x_pred": xt,
                "x_start": x_start}
