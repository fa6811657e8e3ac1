"""GroupNorm of channels-last point features, its affine and swish in one
kernel: the point branch's GroupNorm / AdaGN (+ swish) of
``models/modules.py`` (SharedMLP, MyGroupNormMLP, the feature embedding).

x [B, ..., C] f32 or bf16; gamma and beta f32, shared [C] or per cloud
[B, C] (AdaGN's modulation folded in: ``AdaGN.affine``; a column slice of a
wider table is read in place, ``kernels.affine_stride``). Statistics per
(cloud, group) over every other axis, in f32 as flax takes them: mean and
E[x^2] - mean^2 clamped at 0; then (x - mean) * rsqrt(var + eps), the affine
and swish in f32, rounded once to ``out_dtype``.

On the card :func:`group_norm_act` launches ``csrc/group_norm.cu`` (its
statistics in double, added in a fixed order); a CPU tensor takes
:func:`group_norm_act_plain`. The kernel has no backward: the modules call
the op only where :func:`fuses` holds (the card, no gradient wanted) and
keep their own composition elsewhere. That composition rounds twice where
the fused op rounds once: the GroupNorm's output to the compute dtype, then
AdaGN's modulation and swish in that dtype. This is K1's rule already
(``ops/conv3d_gn.py``): on the card the bf16 output is within one bf16 ulp
of the f32 result, where the modules' bf16 composition may be several.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import kernels

# the kernel's limits (csrc/group_norm.cu)
THREADS = 256  # a block: C / VEC threads a row
MAX_GROUPS = 1024
MAX_CHUNKS = 32  # partials a (cloud, group)


def fuses(x: torch.Tensor, *sources) -> bool:
    """True where GroupNorm (+ swish) of x runs as the kernel: x on the card
    and no gradient wanted of x or of the affine's ``sources`` (tensors, or
    modules for their parameters)."""
    if not kernels.on_card(x):
        return False
    if not torch.is_grad_enabled():
        return True
    return not any(t.requires_grad for s in (x, *sources)
                   for t in (s.parameters() if isinstance(s, nn.Module) else (s,)))


def group_norm_stats(x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """Normalise x [B, ..., C] per (batch, group) over every other axis, in
    f32, variance E[x^2] - E[x]^2 clamped at 0 (flax.linen.GroupNorm)."""
    B, C = x.shape[0], x.shape[-1]
    xg = x.float().reshape(B, -1, groups, C // groups)
    m = xg.mean(dim=(1, 3), keepdim=True)
    v = ((xg * xg).mean(dim=(1, 3), keepdim=True) - m * m).clamp_min(0.0)
    return ((xg - m) * torch.rsqrt(v + eps)).reshape(x.shape)


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         groups: int, eps: float = 1e-5, act: bool = False,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: statistics, affine and swish
    in f32, one rounding to ``out_dtype`` (x's dtype when None)."""
    B, C = x.shape[0], x.shape[-1]
    shape = (B,) + (1,) * (x.dim() - 2) + (C,)
    y = (group_norm_stats(x, groups, eps) * gamma.float().expand(B, C).reshape(shape)
         + beta.float().expand(B, C).reshape(shape))
    if act:
        y = y * torch.sigmoid(y)
    return y.to(out_dtype or x.dtype)


def vector_channels(C: int, dtype: torch.dtype) -> int:
    """The channels a kernel thread loads at once: the widest power of two
    of at most 16 bytes that divides C."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    while C % vec:
        vec //= 2
    return vec


def check_group_norm_shape(B: int, C: int, groups: int, dtype: torch.dtype) -> None:
    """Raise unless the kernel takes this shape: whole groups of at most
    MAX_GROUPS, a row of at most THREADS vectors (C <= 2048 bf16 or 1024 f32
    where C is a multiple of 16 bytes) and B below 65536 (the grid's y)."""
    if groups < 1 or groups > MAX_GROUPS or C % groups:
        raise ValueError(f"group_norm_act takes 1 to {MAX_GROUPS} groups that divide C, "
                         f"got C={C}, groups={groups}")
    if C // vector_channels(C, dtype) > THREADS:
        raise ValueError(f"group_norm_act takes a row of at most {THREADS} vectors of "
                         f"16 bytes or fewer, got C={C} in {dtype}")
    if not 1 <= B < 65536:
        raise ValueError(f"group_norm_act takes 1 <= B < 65536, got {B}")


def _group_norm_act_cuda(x, gamma, beta, groups, eps, act, out_dtype):
    B, C = x.shape[0], x.shape[-1]
    device = kernels.check(("x", x, kernels.DATA, tuple(x.shape)))
    stride = kernels.affine_stride("gamma", gamma, B, C, x.device)
    if kernels.affine_stride("beta", beta, B, C, x.device) != stride:
        raise ValueError("gamma and beta: expected one row stride")
    if out_dtype not in kernels.DATA:
        raise TypeError(f"out_dtype: expected {kernels.DATA}, got {out_dtype}")
    check_group_norm_shape(B, C, groups, x.dtype)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    if x.data_ptr() % 16:  # 16-byte loads from a 16-byte aligned base
        x = x.clone()
    scratch = torch.empty(B * groups * MAX_CHUNKS * 2, dtype=torch.float64, device=x.device)
    kernels.launch("group_norm_act", "p2pb_group_norm_act", device, x.data_ptr(),
                   gamma.data_ptr(), beta.data_ptr(), stride, B,
                   x.numel() // (B * C), C, groups, float(eps), int(act),
                   int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                   y.data_ptr(), scratch.data_ptr())
    return y


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                   eps: float = 1e-5, act: bool = False,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """GroupNorm(groups) of x [B, ..., C] with gamma / beta [C] or [B, C]
    (f32), then swish if ``act``, -> [B, ..., C] of ``out_dtype`` (x's dtype
    when None), rounded once: the kernel on a CUDA tensor, which raises
    where a gradient is wanted (it has none); :func:`group_norm_act_plain`
    on a CPU tensor."""
    out_dtype = out_dtype or x.dtype
    if not kernels.on_card(x):
        return group_norm_act_plain(x, gamma, beta, groups, eps, act, out_dtype)
    if not fuses(x, gamma, beta):
        raise RuntimeError("group_norm_act has no backward; take it where fuses() holds")
    return _group_norm_act_cuda(x.contiguous(), kernels.affine_operand(gamma),
                                kernels.affine_operand(beta), groups, eps, act, out_dtype)
