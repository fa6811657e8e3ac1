"""The Schroedinger-bridge schedule and sampler of
P2P-Bridge (I2SB's symmetric linear schedule, ``ot_ode`` sampling), in
numpy and plain PyTorch.

  std_fwd[t] = sqrt(sum_{s<=t} beta[s]),  std_bwd[t] = sqrt(sum_{s>t} beta[s])
  x_t = mu_x0 x0 + mu_x1 x1          (mu from the product of the two gaussians)
  sampling: x_prev = mu_x0' pred_x0 + mu_xn' x_n,  pred_x0 = x_n - std_fwd[n] eps
"""

from __future__ import annotations

import numpy as np
import torch


def space_indices(num_steps: int, count: int):
    stride = 1.0 if count <= 1 else (num_steps - 1) / (count - 1)
    return [round(i * stride) for i in range(count)]


def _product(s1, s2):
    denom = s1 ** 2 + s2 ** 2
    return s2 ** 2 / denom, s1 ** 2 / denom, (s1 ** 2 * s2 ** 2) / denom


class Schedule:
    def __init__(self, cfg: dict):
        d = cfg["diffusion"]
        if not d.get("ot_ode", True) or d.get("add_x1_noise", False) or d.get("cond_x1", False):
            raise NotImplementedError("the reference samples ot_ode bridges only")
        if d.get("objective", "pred_noise") != "pred_noise":
            raise NotImplementedError("the reference predicts noise only")
        n = int(d["timesteps"])
        scale = 1000.0 / n
        betas = np.linspace((d["beta_start"] * scale) ** 0.5, (d["beta_end"] * scale) ** 0.5, n,
                            dtype=np.float64) ** 2
        betas = np.concatenate([betas[: n // 2], np.flip(betas[: n // 2])])
        self.timesteps = n
        self.std_fwd = np.sqrt(np.cumsum(betas))
        std_bwd = np.sqrt(np.flip(np.cumsum(np.flip(betas))))
        self.mu_x0, self.mu_x1, _ = _product(self.std_fwd, std_bwd)
        self.noise_levels = np.linspace(d["t0"], d["T"], n, dtype=np.float32) * n
        self.f32 = {k: np.asarray(getattr(self, k), np.float32)
                    for k in ("std_fwd", "mu_x0", "mu_x1")}

    def plan(self, steps: int):
        """[(noise level, std_fwd[n], post mu_x0, post mu_xn)] per step, f32."""
        rev = space_indices(self.timesteps, steps + 1)[::-1]
        out = []
        for n, prev in zip(rev[:-1], rev[1:]):
            s_n, s_p = self.std_fwd[n], self.std_fwd[prev]
            mu0, mun, _ = _product(s_p, np.sqrt(s_n ** 2 - s_p ** 2))
            out.append(tuple(float(np.float32(v)) for v in
                             (self.noise_levels[n], s_n, mu0, mun)))
        return out


def step(model, coefs, xt: torch.Tensor, cond: torch.Tensor = None) -> torch.Tensor:
    """One sampling step from xt with the step's (noise level, std_fwd,
    post mu_x0, post mu_xn)."""
    level, std, mu0, mun = coefs
    t = torch.full((xt.shape[0],), level, device=xt.device)
    return mu0 * (xt - std * model(xt, t, cond)) + mun * xt


@torch.no_grad()
def sample(model, schedule: Schedule, x1: torch.Tensor, steps: int,
           cond: torch.Tensor = None, states: list = None) -> torch.Tensor:
    """Reverse bridge sampling from x1 [B, N, 3] -> the final state;
    ``states``, where a list, receives the state after each step."""
    xt = x1
    for coefs in schedule.plan(steps):
        xt = step(model, coefs, xt, cond)
        if states is not None:
            states.append(xt)
    return xt

