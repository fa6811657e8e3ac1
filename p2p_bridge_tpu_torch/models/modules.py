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

Every GroupNorm and AdaGN, alone or with the swish after it
(:func:`norm_act`, the point branch), is one ``group_norm_act`` call,
looked up here at call time: AdaGN's modulation folded into a per-cloud
f32 affine, the affine and swish in f32, one rounding to ``dtype``. The op
picks the kernel or its plain formulation (``ops/group_norm.py``).

Inside ``utils.frozen.frozen_weights()`` (the sampler's steps) a Linear
casts its weight and bias once, not at every call, and on the card the
AdaGNs take their affines from the model's :class:`AffineBank`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..ops.group_norm import group_norm_act
from ..utils.frozen import active, once


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
        bias = None if self.bias is None else once(self.bias, dt, lambda b: b.to(dt))
        return F.linear(x.to(dt), once(self.weight, dt, lambda w: w.to(dt)), bias)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm's parameters, applied channels-last; the statistics and
    the affine in f32, the result in ``dtype`` (f32 when None)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x, act=False):
        """The norm of x, then swish if ``act``: one ``group_norm_act``."""
        return group_norm_act(x, self.weight, self.bias, self.num_groups, self.eps, act,
                              self.compute_dtype)


class AdaGN(nn.Module):
    """GroupNorm whose affine is modulated by a global embedding:
    norm(x) * factor(cond) + shift(cond), folded into the per-cloud affine
    of :meth:`affine`."""

    def __init__(self, channels: int, cond_dim: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-5, dtype=dtype)
        self.emd = Linear(cond_dim, 2 * channels, dtype=dtype)
        self.bank = None  # the model's AffineBank, where it has one

    def affine(self, cond: torch.Tensor):
        """The per-cloud [B, C] f32 affine on the raw group normalisation:
        norm(x) * (scale * factor) + (bias * factor + shift); on the card
        inside ``frozen_weights()`` a view of the model's AffineBank."""
        if self.bank is not None and active() and kernels.on_card(cond):
            return self.bank.affine(self, cond)
        fb = self.emd(cond).float()
        factor, shift = fb.chunk(2, dim=-1)
        return self.norm.weight[None] * factor, self.norm.bias[None] * factor + shift

    def forward(self, x, cond, act=False):
        """The norm of x, then swish if ``act``: one ``group_norm_act``."""
        gn = self.norm
        return group_norm_act(x, *self.affine(cond), gn.num_groups, gn.eps, act,
                              gn.compute_dtype)


class AffineBank:
    """The AdaGNs of one model (one compute dtype, one conditioning width):
    all their affines of a conditioning from one product with their stacked
    emd weights, in AdaGN.affine's operations (the emd output rounded to
    the compute dtype, the fold in f32). Each AdaGN's [B, C] is a column
    view of two [B, sum C] tables, which the kernels read by their row
    stride. Used on the card inside ``frozen_weights()``, where the stacked
    weights are made once a sampler call and the tables once a step."""

    def __init__(self, adagns):
        self.adagns = list(adagns)
        self.columns, c = {}, 0
        for m in self.adagns:
            self.columns[id(m)] = (c, c + m.norm.num_channels)
            c += m.norm.num_channels

    def _stacked(self, _):
        """(emd weight and bias, the factor rows first, in the compute dtype;
        the norms' scales and biases)."""
        ms, dt = self.adagns, self.adagns[0].emd.compute_dtype
        w = [m.emd.weight.chunk(2) for m in ms]
        b = [m.emd.bias.chunk(2) for m in ms]
        return (torch.cat([f for f, _ in w] + [s for _, s in w]).to(dt),
                torch.cat([f for f, _ in b] + [s for _, s in b]).to(dt),
                torch.cat([m.norm.weight for m in ms]), torch.cat([m.norm.bias for m in ms]))

    def _tables(self, cond):
        weight, bias, scale, shift = once(self.adagns[0].emd.weight, self, self._stacked)
        factor, add = F.linear(cond.to(weight.dtype), weight, bias).float().chunk(2, dim=-1)
        return scale[None] * factor, shift[None] * factor + add

    def affine(self, m: AdaGN, cond: torch.Tensor):
        gamma, beta = once(cond, self, self._tables)
        a, b = self.columns[id(m)]
        return gamma[:, a:b], beta[:, a:b]


def norm_act(norm: nn.Module, x: torch.Tensor,
             cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """swish(``norm`` of x), ``norm`` a GroupNorm, an AdaGN of ``cond`` or a
    MyGroupNorm (its first ``keep`` channels normalised, the rest through
    swish alone): one ``group_norm_act`` call a norm."""
    if isinstance(norm, MyGroupNorm):
        keep = norm.keep
        if keep == x.shape[-1]:
            return norm_act(norm.group_norm, x)
        if not keep:
            return swish(x)
        return torch.cat([norm_act(norm.group_norm, x[..., :keep]), swish(x[..., keep:])], -1)
    # forward, not __call__: no module hooks on the sampler's path
    if isinstance(norm, AdaGN):
        return norm.forward(x, cond, act=True)
    return norm.forward(x, act=True)


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
            x = norm_act(self.layers[i + 1], self.layers[i](x), cond)
        return x


class MyGroupNorm(nn.Module):
    """GroupNorm(min_groups) over the first C - C % min_groups channels;
    the rest pass through (identity when C < min_groups). Applied with the
    swish after it by :func:`norm_act`."""

    def __init__(self, channels: int, min_groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.keep = channels - channels % min_groups
        if self.keep:
            self.group_norm = GroupNorm(min_groups, self.keep, eps=1e-5, dtype=dtype)


class _MyGroupNormLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.mlp = nn.Sequential(Linear(in_channels, out_channels, dtype=dtype),
                                 MyGroupNorm(out_channels, dtype=dtype), Swish())

    def forward(self, x):
        linear, norm, _ = self.mlp
        return norm_act(norm, linear(x))


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
