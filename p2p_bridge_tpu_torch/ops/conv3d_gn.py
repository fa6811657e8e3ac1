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
tensor it runs the plain version.

The backward is that of the JAX package (wconv3d_kernel.py ``_make_conv_gn``):
the gradient of the composition :func:`conv3d_gn_reference`, a SAME conv in
x's dtype followed by the f32 GroupNorm, recomputed from the saved inputs.
Its conv transposes are PyTorch's (cuDNN on the card, pinned to its
deterministic algorithms), as the JAX package leaves them to XLA outside
any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels


def apply_group_norm(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     groups: int, eps: float, act: bool,
                     staged: torch.dtype | None = None) -> torch.Tensor:
    """GroupNorm over all voxels per (cloud, group), variance E[y^2] - m^2,
    affine gamma/beta of shape [C] or [B, C], optional swish. The statistics
    come from y; with ``staged``, the values normalised are y rounded to
    that dtype (a pre-norm grid stored in the compute dtype)."""
    B, C = y.shape[0], y.shape[-1]
    yg = y.float().reshape(B, -1, groups, C // groups)
    m = yg.mean(dim=(1, 3), keepdim=True)
    v = (yg * yg).mean(dim=(1, 3), keepdim=True) - m * m
    if staged is not None:
        yg = y.to(staged).float().reshape(yg.shape)
    yn = ((yg - m) * torch.rsqrt(v + eps)).reshape(y.shape)
    spatial = [1] * (y.dim() - 2)
    gamma = gamma.float().expand(B, C).reshape(B, *spatial, C)
    beta = beta.float().expand(B, C).reshape(B, *spatial, C)
    yn = yn * gamma + beta
    if act:
        yn = yn * torch.sigmoid(yn)
    return yn.to(y.dtype)


def conv3d_gn_plain(x, weight, bias, gamma, beta, groups=8, eps=1e-5, act=False):
    """In f32 on x's and weight's values (exact products of bf16 inputs);
    statistics from the f32 conv + bias, which is staged in x's dtype before
    it is normalised (the identity for f32), stored in x's dtype."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), weight.float().permute(4, 3, 0, 1, 2),
                 bias.float(), padding=1)
    y = apply_group_norm(y.permute(0, 2, 3, 4, 1), gamma, beta, groups, eps, act,
                         staged=x.dtype)
    return y.to(x.dtype)


def pad_channels(x, weight):
    """x [..., Cin] and weight [3, 3, 3, Cin, Cout] with zero channels added
    up to a multiple of 32, as the bf16 kernel takes them (whole k-chunks;
    TMA rows of 64 or 128 bytes). The convolution is the same: the added
    products are 0."""
    pad = -x.shape[-1] % 32
    if pad == 0:
        return x, weight
    return F.pad(x, (0, pad)), F.pad(weight, (0, 0, 0, pad))


def check_wgmma_shape(R: int, cout: int, groups: int) -> None:
    """Raise unless the bf16 kernel takes this shape: 128-voxel boxes of one
    cloud (R a power of two >= 8) by channel tiles of N, the widest of 256,
    128, 64, 32 that divides Cout, whose GroupNorm partials cover N / 8
    channels each, so a group must be whole slots of N / 8."""
    if R < 8 or R & (R - 1):
        raise ValueError(f"bf16 conv3d_gn takes a power-of-two R >= 8, got {R}")
    if cout % 32:
        raise ValueError(f"bf16 conv3d_gn takes Cout a multiple of 32, got {cout}")
    n = next(n for n in (256, 128, 64, 32) if cout % n == 0)
    if (cout // groups) % (n // 8):
        raise ValueError(f"bf16 conv3d_gn: a group of Cout={cout} / groups={groups} "
                         f"channels is not a multiple of {n // 8}")


def conv3d_gn_reference(x, weight, bias, gamma, beta, groups=8, eps=1e-5, act=False):
    """The composition the backward differentiates: the conv in x's dtype
    (bias cast to it, as flax promotes it), then :func:`apply_group_norm`."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight.permute(4, 3, 0, 1, 2),
                 bias.to(x.dtype), padding=1)
    return apply_group_norm(y.permute(0, 2, 3, 4, 1), gamma, beta, groups, eps, act)


def _conv3d_gn_cuda(x, weight, bias, gamma, beta, groups, eps, act):
    B, R = x.shape[0], x.shape[1]
    cin, cout = weight.shape[3], weight.shape[4]
    affine_shape = (B, cout) if gamma.dim() == 2 else (cout,)
    device = kernels.check(("x", x, kernels.DATA, (B, R, R, R, cin)),
                           ("weight", weight, x.dtype, (3, 3, 3, cin, cout)),
                           ("bias", bias, torch.float32, (cout,)),
                           ("gamma", gamma, torch.float32, affine_shape),
                           ("beta", beta, torch.float32, affine_shape))
    dev, dt = x.device, x.dtype
    if cout % groups:
        raise ValueError(f"Cout={cout} is not a multiple of groups={groups}")
    bf16 = int(dt == torch.bfloat16)
    if bf16:
        check_wgmma_shape(R, cout, groups)
        x, weight = pad_channels(x, weight)
        if x.data_ptr() % 16:  # TMA reads from a 16-byte aligned base
            x = x.clone()
        cin = x.shape[-1]
        # [dx, dz, dy, Cout, Cin]: per (dx, dz) and k-chunk one TMA box holds
        # the K-major weight tiles of the three dy taps
        weight = weight.permute(0, 2, 1, 4, 3).contiguous()
    y = torch.empty((B, R, R, R, cout), dtype=dt, device=dev)
    nbytes = kernels.entry_points()["p2pb_conv3d_gn_scratch_bytes"](B, R, cout, groups, bf16)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    kernels.launch(
        "conv3d_gn", "p2pb_conv3d_gn", device, x.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        int(gamma.dim() == 2), B, R, cin, cout, groups, eps, int(act), bf16,
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
    cloud (the AdaGN fold) -> [B, R, R, R, Cout] of x's dtype."""
    return _Conv3dGN.apply(x.contiguous(), weight.contiguous(), bias.contiguous(),
                           gamma.contiguous(), beta.contiguous(), groups, eps, act)
