"""3x3x3 SAME voxel convolution + GroupNorm (+ swish), the contract of
p2p_bridge_tpu/models/modules.py:428-434 (ZPackConv3d with ``gn``) and the
math of p2p_bridge_tpu/ops/pallas/conv3d_kernel.py:_ref_conv and
_apply_gn_xla.

x and weight are f32 or bf16 (the compute dtype); bias, gamma and beta
are f32. The conv accumulates in f32, the GroupNorm statistics come from
that f32 accumulator and the result is stored in x's dtype, as the TPU
kernel's epilogue does. On a CUDA tensor :func:`conv3d_gn` launches
kernel K1 (``csrc/conv3d_gn.cu``); on a CPU tensor it runs the plain
version.

The backward is that of the JAX package (wconv3d_kernel.py ``_make_conv_gn``):
the gradient of the composition :func:`conv3d_gn_reference`, a SAME conv in
x's dtype followed by the f32 GroupNorm, recomputed from the saved inputs.
Its conv transposes are PyTorch's (cuDNN on the card), as the JAX package
leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels


def apply_group_norm(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     groups: int, eps: float, act: bool) -> torch.Tensor:
    """GroupNorm over all voxels per (cloud, group), variance E[y^2] - m^2,
    affine gamma/beta of shape [C] or [B, C], optional swish."""
    B, C = y.shape[0], y.shape[-1]
    yg = y.float().reshape(B, -1, groups, C // groups)
    m = yg.mean(dim=(1, 3), keepdim=True)
    v = (yg * yg).mean(dim=(1, 3), keepdim=True) - m * m
    yn = ((yg - m) * torch.rsqrt(v + eps)).reshape(y.shape)
    spatial = [1] * (y.dim() - 2)
    gamma = gamma.float().expand(B, C).reshape(B, *spatial, C)
    beta = beta.float().expand(B, C).reshape(B, *spatial, C)
    yn = yn * gamma + beta
    if act:
        yn = yn * torch.sigmoid(yn)
    return yn.to(y.dtype)


def conv3d_gn_plain(x, weight, bias, gamma, beta, groups=8, eps=1e-5, act=False):
    """In f32 on x's and weight's values (exact products of bf16 inputs),
    stored in x's dtype."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), weight.float().permute(4, 3, 0, 1, 2),
                 bias.float(), padding=1)
    y = apply_group_norm(y.permute(0, 2, 3, 4, 1), gamma, beta, groups, eps, act)
    return y.to(x.dtype)


def conv3d_gn_reference(x, weight, bias, gamma, beta, groups=8, eps=1e-5, act=False):
    """The composition the backward differentiates: the conv in x's dtype
    (bias cast to it, as flax promotes it), then :func:`apply_group_norm`."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight.permute(4, 3, 0, 1, 2),
                 bias.to(x.dtype), padding=1)
    return apply_group_norm(y.permute(0, 2, 3, 4, 1), gamma, beta, groups, eps, act)


def _conv3d_gn_cuda(x, weight, bias, gamma, beta, groups, eps, act):
    B, R = x.shape[0], x.shape[1]
    cin, cout = weight.shape[3], weight.shape[4]
    dev, dt = x.device, kernels.data_dtype(x)
    kernels.require(x, "x", dt, (B, R, R, R, cin), dev)
    kernels.require(weight, "weight", dt, (3, 3, 3, cin, cout), dev)
    kernels.require(bias, "bias", torch.float32, (cout,), dev)
    affine_shape = (B, cout) if gamma.dim() == 2 else (cout,)
    kernels.require(gamma, "gamma", torch.float32, affine_shape, dev)
    kernels.require(beta, "beta", torch.float32, affine_shape, dev)
    if cout % groups:
        raise ValueError(f"Cout={cout} is not a multiple of groups={groups}")
    if dt == torch.bfloat16 and cout % 8:
        raise ValueError(f"bf16 conv3d_gn needs Cout % 8 == 0, got Cout={cout}")
    bf16 = int(dt == torch.bfloat16)
    lib = kernels.library()
    y = torch.empty((B, R, R, R, cout), dtype=dt, device=dev)
    scratch = torch.empty(lib.p2pb_conv3d_gn_scratch_bytes(B, R, cout, groups, bf16),
                          dtype=torch.uint8, device=dev)
    kernels.launch(
        "conv3d_gn", "p2pb_conv3d_gn", dev, x.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        int(gamma.dim() == 2), B, R, cin, cout, groups, eps, int(act), bf16,
        y.data_ptr(), scratch.data_ptr())
    return y


class _Conv3dGN(torch.autograd.Function):
    """K1 forward; the backward recomputes :func:`conv3d_gn_reference`."""

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
        with torch.enable_grad():
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
