"""Neural-net building blocks (port of p2p_bridge_tpu/models/modules.py).

Channels-last like the JAX package: points [B, N, C], grouped points
[B, M, K, C]. Module and parameter names follow the reference torch
``state_dict`` keys (see p2p_bridge_tpu/utils/torch_compat.py), so
``convert_torch_state_dict(port.state_dict(), flax_template)`` maps the
port to the JAX tree with no new mapping code.

Compute dtype, as flax's ``dtype=`` with f32 parameters: parameters stay
f32; a ``Linear`` casts its input, weight and bias to ``dtype`` and
returns ``dtype`` (bf16 products accumulate in f32); a ``GroupNorm``
takes its statistics in f32 and returns ``dtype``, or f32 when ``dtype``
is None (flax's GroupNorm without a dtype).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding [B] -> [B, dim] f32."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=timesteps.device)
        * (-math.log(10000.0) / (half - 1)))
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def time_embed_mlp(dim: int) -> nn.Sequential:
    """Linear -> LeakyReLU(0.1) -> Linear over the sinusoidal embedding,
    in f32 whatever the model computes in (TimeEmbedMLP has no dtype)."""
    return nn.Sequential(nn.Linear(dim, dim), nn.LeakyReLU(0.1), nn.Linear(dim, dim))


class Linear(nn.Linear):
    """nn.Linear computing in ``dtype`` (flax Dense(dtype=...))."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def group_norm_stats(x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """Normalise x [B, ..., C] per (batch, group) over every other axis, in
    f32, variance E[x^2] - E[x]^2 clamped at 0 (flax.linen.GroupNorm)."""
    B, C = x.shape[0], x.shape[-1]
    xg = x.float().reshape(B, -1, groups, C // groups)
    m = xg.mean(dim=(1, 3), keepdim=True)
    v = ((xg * xg).mean(dim=(1, 3), keepdim=True) - m * m).clamp_min(0.0)
    return ((xg - m) * torch.rsqrt(v + eps)).reshape(x.shape)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm's parameters, applied channels-last; the affine in f32,
    the result in ``dtype`` (f32 when None)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x):
        y = group_norm_stats(x, self.num_groups, self.eps) * self.weight + self.bias
        return y.to(self.compute_dtype)


class AdaGN(nn.Module):
    """GroupNorm whose affine is modulated by a global embedding:
    norm(x) * factor(cond) + shift(cond), the product and sum in
    ``dtype``."""

    def __init__(self, channels: int, cond_dim: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-5, dtype=dtype)
        self.emd = Linear(cond_dim, 2 * channels, dtype=dtype)

    def affine(self, cond: torch.Tensor):
        """The per-cloud [B, C] f32 affine on the raw group normalisation:
        norm(x) * (scale * factor) + (bias * factor + shift)."""
        fb = self.emd(cond).float()
        factor, shift = fb.chunk(2, dim=-1)
        return self.norm.weight[None] * factor, self.norm.bias[None] * factor + shift

    def forward(self, x, cond):
        fb = self.emd(cond)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (-1,)
        factor, shift = fb.view(shape[:-1] + (2 * self.norm.num_channels,)).chunk(2, dim=-1)
        return self.norm(x) * factor + shift


class SE(nn.Module):
    """Squeeze-excite gate [B, C] from the pooled grid [B, C]."""

    def __init__(self, channels: int, reduction: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = nn.Sequential(
            Linear(channels, channels // reduction, bias=False, dtype=dtype), nn.ReLU(),
            Linear(channels // reduction, channels, bias=False, dtype=dtype), nn.Sigmoid())

    def forward(self, pooled):
        return self.fc(pooled)


class LinearAttention(nn.Module):
    """Softmax-key linear attention over [B, N, C]; both contractions
    accumulate in f32 (preferred_element_type in the JAX module)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Linear(dim, 3 * heads * dim_head, bias=False, dtype=dtype)
        self.to_out = Linear(heads * dim_head, dim, dtype=dtype)

    def forward(self, x):
        B, N, _ = x.shape
        h, d = self.heads, self.dim_head
        q, k, v = self.to_qkv(x).reshape(B, N, 3, h, d).unbind(2)
        k = torch.softmax(k, dim=1)  # over the sequence
        context = torch.einsum("bnhd,bnhe->bhde", k.float(), v.float())
        out = torch.einsum("bhde,bnhd->bnhe", context, q.float()).to(q.dtype)
        return self.to_out(out.reshape(B, N, h * d))


class Attention(nn.Module):
    """Full softmax attention over [B, N, C] ("flash" in the configs).

    As the JAX module, whose Dense layers have no dtype: the projections
    compute in f32 whatever the model computes in (flax promotes a bf16
    input with f32 parameters to f32), the logits and the softmax are f32,
    the probabilities are cast to v's dtype (f32) for the second product,
    and its result is cast back to the input's dtype before ``to_out``,
    which returns f32. ``qk_norm`` scales q and k to unit L2 norm, times
    sqrt(d) and the learned per-head gains ``q_gamma`` / ``k_gamma``
    [h, 1, d]."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, qk_norm: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.qk_norm = heads, dim_head, qk_norm
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, 2 * inner, bias=False)
        self.to_out = Linear(inner, dim, bias=False)
        if qk_norm:
            self.q_gamma = nn.Parameter(torch.ones(heads, 1, dim_head))
            self.k_gamma = nn.Parameter(torch.ones(heads, 1, dim_head))

    def forward(self, x):
        B, N, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x).reshape(B, N, h, d)
        k, v = (t.reshape(B, N, h, d) for t in self.to_kv(x).chunk(2, dim=-1))
        if self.qk_norm:
            q = _rms_norm(q) * math.sqrt(d) * self.q_gamma.transpose(0, 1)[None]
            k = _rms_norm(k) * math.sqrt(d) * self.k_gamma.transpose(0, 1)[None]
        attn = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * d ** -0.5, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype), v).to(x.dtype)
        return self.to_out(out.reshape(B, N, h * d))


def _rms_norm(x: torch.Tensor) -> torch.Tensor:
    """x over its L2 norm on the last axis, the norm clamped at 1e-12."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class SharedMLP(nn.Module):
    """[Linear, GroupNorm | AdaGN, swish] per output width, on any
    channels-last rank. AdaGN when ``cond_dim`` > 0."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 cond_dim: int = 0, groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = []
        for oc in out_channels:
            norm = (AdaGN(oc, cond_dim, groups, dtype=dtype) if cond_dim
                    else GroupNorm(groups, oc, eps=1e-5, dtype=dtype))
            layers += [Linear(in_channels, oc, dtype=dtype), norm, Swish()]
            in_channels = oc
        self.layers = nn.Sequential(*layers)

    def forward(self, x, cond: Optional[torch.Tensor] = None):
        for i in range(0, len(self.layers), 3):
            x = self.layers[i](x)
            norm = self.layers[i + 1]
            x = norm(x, cond) if isinstance(norm, AdaGN) else norm(x)
            x = swish(x)
        return x


class MyGroupNorm(nn.Module):
    """GroupNorm(min_groups) over the first C - C % min_groups channels;
    the rest pass through (identity when C < min_groups)."""

    def __init__(self, channels: int, min_groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.keep = channels - channels % min_groups
        if self.keep:
            self.group_norm = GroupNorm(min_groups, self.keep, eps=1e-5, dtype=dtype)

    def forward(self, x):
        if not self.keep:
            return x
        if self.keep == x.shape[-1]:
            return self.group_norm(x)
        return torch.cat([self.group_norm(x[..., :self.keep]), x[..., self.keep:]], -1)


class _MyGroupNormLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.mlp = nn.Sequential(Linear(in_channels, out_channels, dtype=dtype),
                                 MyGroupNorm(out_channels, dtype=dtype), Swish())

    def forward(self, x):
        return self.mlp(x)


class MyGroupNormMLP(nn.Module):
    """Linear(bias) + MyGroupNorm + swish per output width."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = len(channels)
        for k, oc in enumerate(channels):
            setattr(self, f"shared_mlp_{k}", _MyGroupNormLayer(in_channels, oc, dtype))
            in_channels = oc

    def forward(self, x):
        for k in range(self.depth):
            x = getattr(self, f"shared_mlp_{k}")(x)
        return x


class Pnet2Stage(nn.Module):
    """Global-embedding PointNet: [B, N, in_dim] -> [B, mlp2[-1]]."""

    def __init__(self, in_dim: int, mlp1: Sequence[int], mlp2: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp1 = MyGroupNormMLP(in_dim, mlp1, dtype)
        self.mlp2 = MyGroupNormMLP(2 * mlp1[-1], mlp2, dtype)

    def forward(self, x):
        feat = self.mlp1(x)
        global_feat = feat.amax(dim=1, keepdim=True)
        feat = torch.cat([feat, global_feat.expand_as(feat)], dim=-1)
        return self.mlp2(feat).amax(dim=1)
