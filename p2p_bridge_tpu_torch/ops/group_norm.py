"""GroupNorm of channels-last features, its affine and swish: the port's one
GroupNorm formulation, in the two halves of ``csrc/group_norm.cuh``.

x [B, ..., C] f32 or bf16; gamma and beta f32, shared [C] or per cloud
[B, C] (AdaGN's modulation folded in: ``AdaGN.affine``; a column slice of a
wider table is read in place, ``kernels.affine_stride``).
:func:`group_moments` takes the statistics per (cloud, group) over every
other axis, in f32 as flax takes them: mean and E[x^2] - mean^2 clamped at
0 (``gn_moments``). :func:`group_normalise` computes (x - mean) *
rsqrt(var + eps), the affine and swish in f32, rounded once to
``out_dtype`` (``gn_normalise``). :func:`group_norm_act_plain` is the two
composed; K1's plain version and backward (``ops/conv3d_gn.py``) take the
moments of the f32 accumulator and normalise the grid staged in x's dtype.

:func:`group_norm_act` decides its route alone: on a CUDA tensor it
launches ``csrc/group_norm.cu`` (its statistics in double, added in a fixed
order), whose backward, where a gradient is wanted of x, gamma or beta,
recomputes the plain formulation from the saved inputs and differentiates
it (the kernel has none of its own); on the CPU it runs the plain
formulation, which autograd differentiates. Both round once: the bf16
output is within one bf16 ulp of the f32 result.
"""

from __future__ import annotations

import torch

from .. import kernels

# the kernel's limits (csrc/group_norm.cu)
THREADS = 256  # a block: C / VEC threads a row
MAX_GROUPS = 1024
MAX_CHUNKS = 32  # partials a (cloud, group)


def group_moments(x: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean and variance of x [B, ..., C] per (cloud, group) over every
    other axis, in f32, the variance E[x^2] - mean^2 clamped at 0
    (flax.linen.GroupNorm): each [B, 1, groups, 1]."""
    B, C = x.shape[0], x.shape[-1]
    xg = x.float().reshape(B, -1, groups, C // groups)
    m = xg.mean(dim=(1, 3), keepdim=True)
    return m, ((xg * xg).mean(dim=(1, 3), keepdim=True) - m * m).clamp_min(0.0)


def group_normalise(x: torch.Tensor, moments: tuple[torch.Tensor, torch.Tensor],
                    gamma: torch.Tensor, beta: torch.Tensor, eps: float, act: bool,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) with the :func:`group_moments` of x or
    of the values x was rounded from, then gamma / beta and swish if
    ``act``, all in f32, rounded once to ``out_dtype``."""
    m, v = moments
    B, C = x.shape[0], x.shape[-1]
    shape = (B,) + (1,) * (x.dim() - 2) + (C,)
    xg = x.float().reshape(B, -1, m.shape[2], C // m.shape[2])
    y = (((xg - m) * torch.rsqrt(v + eps)).reshape(x.shape)
         * gamma.float().expand(B, C).reshape(shape) + beta.float().expand(B, C).reshape(shape))
    if act:
        y = y * torch.sigmoid(y)
    return y.to(out_dtype)


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         groups: int, eps: float = 1e-5, act: bool = False,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: statistics, affine and swish
    in f32, one rounding to ``out_dtype`` (x's dtype when None)."""
    return group_normalise(x, group_moments(x, groups), gamma, beta, eps, act,
                           out_dtype or x.dtype)


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


class _GroupNormAct(torch.autograd.Function):
    """The kernel's forward; the backward recomputes
    :func:`group_norm_act_plain` from the saved inputs and differentiates
    it."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, act, out_dtype):
        ctx.save_for_backward(x, gamma, beta)
        ctx.options = (groups, eps, act, out_dtype)
        return _group_norm_act_cuda(x, gamma, beta, groups, eps, act, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = group_norm_act_plain(*inputs, *ctx.options)
            got = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], grad))
        return (*(next(got) if n else None for n in needs), None, None, None, None)


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                   eps: float = 1e-5, act: bool = False,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """GroupNorm(groups) of x [B, ..., C] with gamma / beta [C] or [B, C]
    (f32), then swish if ``act``, -> [B, ..., C] of ``out_dtype`` (x's dtype
    when None), rounded once: the kernel on a CUDA tensor (with the plain
    formulation's gradient where one is wanted of x, gamma or beta), else
    :func:`group_norm_act_plain`. Without a gradient to track it skips the
    autograd node and what it saves."""
    out_dtype = out_dtype or x.dtype
    if not kernels.on_card(x):
        return group_norm_act_plain(x, gamma, beta, groups, eps, act, out_dtype)
    args = (x.contiguous(), kernels.affine_operand(gamma), kernels.affine_operand(beta))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GroupNormAct.apply(*args, groups, eps, act, out_dtype)
    return _group_norm_act_cuda(*args, groups, eps, act, out_dtype)
