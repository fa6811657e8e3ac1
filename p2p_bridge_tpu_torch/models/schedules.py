"""Diffusion Schroedinger-bridge schedule math, host-side numpy (a copy of
p2p_bridge_tpu/models/schedules.py; tests hold the two equal).

  std_fwd[t] = sqrt(sum_{s<=t} beta[s])            # forward marginal std
  std_bwd[t] = sqrt(sum_{s>t}  beta[s])            # backward marginal std
  mu_x0, mu_x1, var = gaussian_product(std_fwd, std_bwd)
  q(x_t | x0, x1) = N(mu_x0*x0 + mu_x1*x1, var)

Sampling posterior between two retained steps:

  std_delta = sqrt(std_fwd[n]^2 - std_fwd[nprev]^2)
  mu_x0, mu_xn, var = gaussian_product(std_fwd[nprev], std_delta)
  x_{nprev} = mu_x0*pred_x0 + mu_xn*x_n (+ sqrt(var)*eps  if not ot_ode)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


def space_indices(num_steps: int, count: int) -> List[int]:
    """Evenly spaced integer indices over [0, num_steps), rounded with
    Python's round (half to even)."""
    assert count <= num_steps
    frac_stride = 1.0 if count <= 1 else (num_steps - 1) / (count - 1)
    cur_idx = 0.0
    taken = []
    for _ in range(count):
        taken.append(round(cur_idx))
        cur_idx += frac_stride
    return taken


def compute_gaussian_product_coef(
    sigma1: np.ndarray, sigma2: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Coefficients of the product of two gaussians."""
    denom = sigma1**2 + sigma2**2
    coef1 = sigma2**2 / denom
    coef2 = sigma1**2 / denom
    var = (sigma1**2 * sigma2**2) / denom
    return coef1, coef2, var


def make_beta_schedule(n_timestep: int = 1000, linear_start: float = 1e-4,
                       linear_end: float = 2e-2) -> np.ndarray:
    """Quadratic-in-sqrt linear beta schedule."""
    scale = 1000.0 / n_timestep
    linear_start = linear_start * scale
    linear_end = linear_end * scale
    return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                       dtype=np.float64) ** 2


@dataclass(frozen=True)
class BridgeSchedule:
    """All precomputed schedule arrays (float32 numpy)."""

    timesteps: int
    betas: np.ndarray  # [T]
    std_fwd: np.ndarray  # [T]
    std_bwd: np.ndarray  # [T]
    std_sb: np.ndarray  # [T]
    mu_x0: np.ndarray  # [T]
    mu_x1: np.ndarray  # [T]
    noise_levels: np.ndarray  # [T] network-facing time values
    loss_weight: np.ndarray  # [T] SNR-derived weights

    @classmethod
    def create(cls, timesteps: int = 1000, beta_start: float = 1e-4,
               beta_end: float = 2e-2, t0: float = 1e-4, T: float = 1.0,
               symmetric: bool = True, objective: str = "pred_noise",
               snr_clip: bool = False) -> "BridgeSchedule":
        betas = make_beta_schedule(timesteps, beta_start, beta_end)
        if symmetric:
            if timesteps % 2 != 0:
                raise ValueError("symmetric schedule requires even timesteps")
            betas = np.concatenate(
                [betas[: timesteps // 2], np.flip(betas[: timesteps // 2])])

        std_fwd = np.sqrt(np.cumsum(betas))
        std_bwd = np.sqrt(np.flip(np.cumsum(np.flip(betas))))
        mu_x0, mu_x1, var = compute_gaussian_product_coef(std_fwd, std_bwd)
        std_sb = np.sqrt(var)

        noise_levels = np.linspace(t0, T, timesteps, dtype=np.float32) * timesteps

        alphas_cumprod = np.cumprod(1.0 - betas)
        snr = alphas_cumprod / (1.0 - alphas_cumprod)
        clipped = np.minimum(snr, 5.0) if snr_clip else snr.copy()
        if objective == "pred_noise":
            loss_weight = clipped / snr
        elif objective == "pred_x0":
            loss_weight = clipped
        else:
            raise ValueError(f"unknown objective: {objective}")

        def f32(a):
            return np.asarray(a, dtype=np.float32)

        return cls(timesteps=timesteps, betas=f32(betas), std_fwd=f32(std_fwd),
                   std_bwd=f32(std_bwd), std_sb=f32(std_sb), mu_x0=f32(mu_x0),
                   mu_x1=f32(mu_x1), noise_levels=f32(noise_levels),
                   loss_weight=f32(loss_weight))

    def sampler_plan(self, sampling_steps: int) -> "SamplerPlan":
        """Per-step posterior coefficients of the reverse pass, walking
        step pairs (prev < n) from T-1 down to 0."""
        assert 0 < sampling_steps < self.timesteps
        steps = space_indices(self.timesteps, sampling_steps + 1)
        rev = steps[::-1]  # descending, rev[-1] == 0
        step_n = np.asarray(rev[:-1], dtype=np.int32)
        step_prev = np.asarray(rev[1:], dtype=np.int32)

        std_n = self.std_fwd[step_n]
        std_prev = self.std_fwd[step_prev]
        std_delta = np.sqrt(std_n**2 - std_prev**2)
        mu_x0, mu_xn, var = compute_gaussian_product_coef(std_prev, std_delta)

        def f32(a):
            return np.asarray(a, dtype=np.float32)

        return SamplerPlan(
            steps=np.asarray(steps, dtype=np.int32), step_n=step_n,
            step_prev=step_prev, std_fwd_n=f32(std_n),
            noise_level_n=f32(self.noise_levels[step_n]),
            post_mu_x0=f32(mu_x0), post_mu_xn=f32(mu_xn),
            post_std=f32(np.sqrt(var)),
            # noise is added only when nprev > 0 and not ot_ode
            noise_mask=f32(step_prev > 0))


@dataclass(frozen=True)
class SamplerPlan:
    """Stacked per-step coefficients of the sampler loop."""

    steps: np.ndarray  # [S+1] ascending retained timesteps
    step_n: np.ndarray  # [S] current step per iteration
    step_prev: np.ndarray  # [S]
    std_fwd_n: np.ndarray  # [S] std_fwd at the current step (eps -> x0)
    noise_level_n: np.ndarray  # [S] network time input at the current step
    post_mu_x0: np.ndarray  # [S]
    post_mu_xn: np.ndarray  # [S]
    post_std: np.ndarray  # [S]
    noise_mask: np.ndarray  # [S] 1.0 where stochastic noise is added

    @property
    def num_steps(self) -> int:
        return int(self.step_n.shape[0])
