"""3x3x3 SAME voxel convolution + GroupNorm (+ swish), the contract of
p2p_bridge_tpu/models/modules.py:428-434 (ZPackConv3d with ``gn``) and the
math of p2p_bridge_tpu/ops/pallas/conv3d_kernel.py:_ref_conv and
_apply_gn_xla.

x and weight are f32 or bf16 (the compute dtype); bias, gamma and beta
are f32. The conv accumulates in f32 and the GroupNorm statistics come
from that f32 accumulator; the pre-norm grid is staged in x's dtype and
normalised from there, and the result is stored in x's dtype, as the TPU
kernel's epilogue does (wconv3d_kernel.py ``_kernel``). On a CUDA tensor
:func:`conv3d_gn` launches kernel K1 (``csrc/conv3d_gn.cu``); on a CPU
tensor it runs the plain version. The GroupNorm arithmetic, here as in the
kernel (``csrc/group_norm.cuh``), is the port's one formulation
(``ops/group_norm.py``).

The backward is that of the JAX package (wconv3d_kernel.py ``_make_conv_gn``):
the gradient of the composition :func:`conv3d_gn_reference`, a SAME conv in
x's dtype followed by the f32 GroupNorm, recomputed from the saved inputs.
Its conv transposes are PyTorch's (cuDNN on the card, pinned to its
deterministic algorithms), as the JAX package leaves them to XLA outside
any Pallas kernel.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import kernels
from ..utils.frozen import once
from .group_norm import group_moments, group_norm_act_plain, group_normalise


def conv3d_gn_plain(x, weight, bias, gamma, beta, groups=8, eps=1e-5, act=False):
    """In f32 on x's and weight's values (exact products of bf16 inputs);
    statistics from the f32 conv + bias, which is staged in x's dtype before
    it is normalised (the identity for f32), stored in x's dtype."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), weight.float().permute(4, 3, 0, 1, 2),
                 bias.float(), padding=1).permute(0, 2, 3, 4, 1)
    return group_normalise(y.to(x.dtype), group_moments(y, groups), gamma, beta, eps, act,
                           x.dtype)


# input channels of each kernel's rows: a multiple of this (kernel_operands)
CIN_MULTIPLE = {torch.bfloat16: 32, torch.float32: 4}


# the f32 kernel is built for R = 8, 16 and 32 (every shipped config's)
F32_MAX_R = 32


def check_tile_shape(R: int, cout: int, groups: int, dtype: torch.dtype) -> None:
    """Raise unless the kernel of ``dtype`` takes this shape: 128-voxel
    boxes of one cloud (R a power of two >= 8, at most F32_MAX_R in f32) by
    channel tiles of N, the widest of 256 (bf16 only), 128, 64, 32 that
    divides Cout, whose GroupNorm partials cover N / 8 channels each, so a
    group must be whole slots of N / 8 (the bf16 tile is the wider, so its
    slots decide for both)."""
    if R < 8 or R & (R - 1) or (dtype == torch.float32 and R > F32_MAX_R):
        raise ValueError(f"conv3d_gn {dtype} takes a power-of-two R >= 8"
                         f"{f' and <= {F32_MAX_R}' if dtype == torch.float32 else ''}, got {R}")
    if cout % 32:
        raise ValueError(f"conv3d_gn takes Cout a multiple of 32, got {cout}")
    n = next(n for n in (256, 128, 64, 32) if cout % n == 0)
    if (cout // groups) % (n // 8):
        raise ValueError(f"conv3d_gn: a group of Cout={cout} / groups={groups} "
                         f"channels is not a multiple of {n // 8}")


def kernel_operands(x, weight):
    """x and weight as K1's kernel for their dtype takes them: Cin padded
    with zero channels (and zero weight rows) to CIN_MULTIPLE: 32 for the
    bf16 kernel (whole k-chunks; TMA rows of 64 or 128 bytes), 4 for the f32
    kernel (16-byte rows for its copies), which leaves the convolution as it
    was (the added products are 0); the f32
    kernel keeps the DHWIO weight [3, 3, 3, Cin, Cout], the bf16 kernel
    takes it as [dx, dz, dy, Cout, Cin] (per (dx, dz) and k-chunk one TMA
    box holds the K-major weight tiles of the three dy taps)."""
    return kernel_input(x), kernel_weight(weight, x.dtype)


def kernel_input(x):
    """The x half of :func:`kernel_operands`."""
    pad = -x.shape[-1] % CIN_MULTIPLE[x.dtype]
    return F.pad(x, (0, pad)) if pad else x


def kernel_weight(weight, dtype):
    """The weight half of :func:`kernel_operands`, for x of ``dtype``."""
    pad = -weight.shape[3] % CIN_MULTIPLE[dtype]
    if pad:
        weight = F.pad(weight, (0, 0, 0, pad))
    if dtype == torch.bfloat16:
        weight = weight.permute(0, 2, 1, 4, 3).contiguous()
    return weight


def conv3d_gn_reference(x, weight, bias, gamma, beta, groups=8, eps=1e-5, act=False):
    """The composition the backward differentiates: the conv in x's dtype
    (bias cast to it, as flax promotes it), then the f32 GroupNorm of its
    output, rounded to x's dtype (:func:`group_norm_act_plain`)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight.permute(4, 3, 0, 1, 2),
                 bias.to(x.dtype), padding=1)
    return group_norm_act_plain(y.permute(0, 2, 3, 4, 1), gamma, beta, groups, eps, act)


@functools.lru_cache(maxsize=None)
def scratch_bytes(B: int, R: int, cout: int, groups: int, bf16: int) -> int:
    """The scratch K1 needs for this shape (its C entry's answer, asked once)."""
    return kernels.entry_points()["p2pb_conv3d_gn_scratch_bytes"](B, R, cout, groups, bf16)


def _conv3d_gn_cuda(x, weight, bias, gamma, beta, groups, eps, act):
    B, R = x.shape[0], x.shape[1]
    cin, cout = weight.shape[3], weight.shape[4]
    device = kernels.check(("x", x, kernels.DATA, (B, R, R, R, cin)),
                           ("weight", weight, x.dtype, (3, 3, 3, cin, cout)),
                           ("bias", bias, torch.float32, (cout,)))
    stride = kernels.affine_stride("gamma", gamma, B, cout, x.device)
    if kernels.affine_stride("beta", beta, B, cout, x.device) != stride:
        raise ValueError("gamma and beta: expected one row stride")
    dev, dt = x.device, x.dtype
    if cout % groups:
        raise ValueError(f"Cout={cout} is not a multiple of groups={groups}")
    bf16 = int(dt == torch.bfloat16)
    check_tile_shape(R, cout, groups, dt)
    # the weight's layout made once a sampler call (utils/frozen.py)
    weight = once(weight, ("k1", dt), lambda w: kernel_weight(w, dt))
    x = kernel_input(x)
    cin = x.shape[-1]
    # both kernels read 16-byte rows from 16-byte aligned bases
    if x.data_ptr() % 16:
        x = x.clone()
    if weight.data_ptr() % 16:
        weight = weight.clone()
    y = torch.empty((B, R, R, R, cout), dtype=dt, device=dev)
    scratch = torch.empty(scratch_bytes(B, R, cout, groups, bf16), dtype=torch.uint8, device=dev)
    kernels.launch(
        "conv3d_gn", "p2pb_conv3d_gn", device, x.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        stride, B, R, cin, cout, groups, eps, int(act), bf16,
        y.data_ptr(), scratch.data_ptr())
    return y


class _Conv3dGN(torch.autograd.Function):
    """K1 forward; the backward recomputes :func:`conv3d_gn_reference` and
    differentiates it with cuDNN pinned, for this backward only, to its
    deterministic algorithms (no benchmark search, no TF32), so that two
    runs give the same bits."""

    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, groups, eps, act):
        ctx.save_for_backward(x, weight, bias, gamma, beta)
        ctx.options = (groups, eps, act)
        if kernels.on_card(x):
            return _conv3d_gn_cuda(x, weight, bias, gamma, beta, groups, eps, act)
        return conv3d_gn_plain(x, weight, bias, gamma, beta, groups, eps, act)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = conv3d_gn_reference(*inputs, *ctx.options)
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return (*(next(got) if n else None for n in needs), None, None, None)


def conv3d_gn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor, groups: int = 8,
              eps: float = 1e-5, act: bool = False) -> torch.Tensor:
    """x [B, R, R, R, Cin] f32 or bf16, weight [3, 3, 3, Cin, Cout] (DHWIO)
    of x's dtype, bias [Cout], gamma/beta [Cout] shared or [B, Cout] per
    cloud (the AdaGN fold) -> [B, R, R, R, Cout] of x's dtype. Without a
    gradient to track it skips the autograd node and what it saves."""
    args = (x.contiguous(), weight.contiguous(), bias.contiguous(),
            kernels.affine_operand(gamma), kernels.affine_operand(beta))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Conv3dGN.apply(*args, groups, eps, act)
    if kernels.on_card(x):
        return _conv3d_gn_cuda(*args, groups, eps, act)
    return conv3d_gn_plain(*args, groups, eps, act)
