"""PVCNN2 U-Net, the P2P-Bridge denoiser, in plain float32 PyTorch.

Parameter names are those of the published PyTorch model's state_dict
(``sa_layers``, ``fp_layers``, ``embedf``, ``global_pnet``, ``global_att``,
``classifier``, ...), so one state_dict loads it and the program alike.
Every product runs in float32 with TF32 off (the caller sets the flags).

``precision`` rounds the two operands of every Linear and 3x3x3 conv
before the product: "f32" leaves them, "bf16" rounds them to bfloat16,
"fp8" to float8 e4m3 with a per-tensor scale (the largest magnitude to
448). Gradients pass the rounding unchanged. "fp8" is the control of the
comparison that decides ``correct``; "bf16" a witness of the program's
compute dtype.

Where a run follows the program's discrete choices: ``masks`` (a list
consumed in call order) supplies the kept elements of each dropout, as the
program drew them (without masks dropout is the identity, as in
evaluation); ``picks`` supplies the furthest point sampling indices of
each set-abstraction stage, as the program picked them. FPS is
discontinuous: a pick that a rounding flips sends the rest of the stage
elsewhere, so the reference takes the program's picks, and the check
holds those picks, by themselves, to the reference's FPS of the same
coordinates. ``recorded``, where a list, receives this model's own picks.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import ops
from .plan import Plan, PVConvSpec, plan_from_config

FP8_MAX = 448.0


class Mismatch(ValueError):
    """The program's choices that a run follows do not fit the reference's
    forward: the program ran other work than it was given."""


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        if precision == "bf16":
            return x.to(torch.bfloat16).float()
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class Precision:
    """How the operands of the products are rounded, and the program's
    choices a run follows (see the module)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision must be f32, bf16 or fp8, got {name!r}")
        self.name = name
        self.masks: Optional[List[torch.Tensor]] = None
        self.picks: Optional[List[torch.Tensor]] = None
        self.recorded: Optional[List[torch.Tensor]] = None
        self.p_drop = 0.0

    def fps(self, coords: torch.Tensor, m: int) -> torch.Tensor:
        if self.picks is not None and (not self.picks or self.picks[0].shape != (len(coords), m)):
            raise Mismatch("the picks to follow do not fit the reference's forward")
        idx = ops.fps(coords, m) if self.picks is None else self.picks.pop(0).long()
        if self.recorded is not None:
            self.recorded.append(idx)
        return idx

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "f32" else _Round.apply(x, self.name)

    def dropout(self, x: torch.Tensor) -> torch.Tensor:
        if self.masks is None or self.p_drop == 0.0:
            return x
        if not self.masks or self.masks[0].shape != x.shape:
            raise Mismatch("the dropout masks do not fit the reference's forward")
        mask = self.masks.pop(0)
        return x * mask.to(x.dtype) / (1.0 - self.p_drop)


class Linear(nn.Linear):
    def __init__(self, cin, cout, bias=True, prec: Precision = None):
        super().__init__(cin, cout, bias=bias)
        self.prec = prec

    def forward(self, x):
        return F.linear(self.prec.round(x), self.prec.round(self.weight), self.bias)


class AdaGN(nn.Module):
    def __init__(self, channels, cond_dim, prec):
        super().__init__()
        self.norm = nn.GroupNorm(8, channels, eps=1e-5)
        self.emd = Linear(cond_dim, 2 * channels, prec=prec)

    def affine(self, cond):
        factor, shift = self.emd(cond).chunk(2, dim=-1)
        return self.norm.weight * factor, self.norm.bias * factor + shift


def _norm(x, norm, cond):
    """GroupNorm(8) of x [B, ..., C] with the affine of ``norm`` (plain or
    AdaGN, per cloud)."""
    if isinstance(norm, AdaGN):
        gamma, beta = norm.affine(cond)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (-1,)
        return ops.group_norm(x, 8) * gamma.view(shape) + beta.view(shape)
    return ops.group_norm(x, norm.num_groups) * norm.weight + norm.bias


class SharedMLP(nn.Module):
    def __init__(self, cin, widths, cond_dim, prec):
        super().__init__()
        layers = []
        for oc in widths:
            norm = AdaGN(oc, cond_dim, prec) if cond_dim else nn.GroupNorm(8, oc, eps=1e-5)
            layers += [Linear(cin, oc, prec=prec), norm, nn.SiLU()]
            cin = oc
        self.layers = nn.Sequential(*layers)

    def forward(self, x, cond=None):
        for i in range(0, len(self.layers), 3):
            x = ops.swish(_norm(self.layers[i](x), self.layers[i + 1], cond))
        return x


class SE(nn.Module):
    def __init__(self, c, prec):
        super().__init__()
        self.fc = nn.Sequential(Linear(c, c // 8, bias=False, prec=prec), nn.ReLU(),
                                Linear(c // 8, c, bias=False, prec=prec), nn.Sigmoid())

    def forward(self, pooled):
        return self.fc(pooled)


class LinearAttention(nn.Module):
    def __init__(self, dim, heads, prec, dim_head=32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Linear(dim, 3 * heads * dim_head, bias=False, prec=prec)
        self.to_out = Linear(heads * dim_head, dim, prec=prec)

    def forward(self, x):
        B, N, _ = x.shape
        q, k, v = self.to_qkv(x).reshape(B, N, 3, self.heads, self.dim_head).unbind(2)
        k = torch.softmax(k, dim=1)
        context = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bhde,bnhd->bnhe", context, q)
        return self.to_out(out.reshape(B, N, -1))


class PVConv(nn.Module):
    def __init__(self, spec: PVConvSpec, cond_dim, use_se, heads, prec):
        super().__init__()
        self.spec, self.prec = spec, prec
        cin, cout = spec.in_channels, spec.out_channels

        def norm():
            return AdaGN(cout, cond_dim, prec) if cond_dim else nn.GroupNorm(8, cout, eps=1e-5)

        layers = [nn.Conv3d(cin, cout, 3, padding=1), norm(), nn.SiLU(), nn.Dropout(),
                  nn.Conv3d(cout, cout, 3, padding=1), norm()]
        if use_se:
            layers.append(SE(cout, prec))
        self.voxel_layers = nn.Sequential(*layers)
        self.point_features = SharedMLP(cin, (cout,), cond_dim, prec)
        if spec.attention:
            self.attn = LinearAttention(cout, heads, prec)

    def _conv(self, grid, conv):
        """3x3x3 SAME conv of a channels-last grid."""
        w = self.prec.round(conv.weight)
        y = F.conv3d(self.prec.round(grid).permute(0, 4, 1, 2, 3), w, conv.bias, padding=1)
        return y.permute(0, 2, 3, 4, 1)

    def forward(self, features, coords, cond=None):
        r = self.spec.resolution
        vl = self.voxel_layers
        vox, cont = ops.voxel_coords(coords, r)
        grid = ops.voxelize(features, vox, r)
        h = ops.swish(_norm(self._conv(grid, vl[0]), vl[1], cond))
        h = self.prec.dropout(h)
        h = _norm(self._conv(h, vl[4]), vl[5], cond)
        fused = ops.devoxelize(h, cont, r)
        if len(vl) > 6:
            fused = fused * vl[6](h.mean(dim=(1, 2, 3)))[:, None, :]
        fused = fused + self.point_features(features, cond)
        if self.spec.attention:
            fused = self.attn(fused)
        return fused


class SAModule(nn.Module):
    def __init__(self, spec, cond_dim, prec):
        super().__init__()
        self.spec, self.prec = spec, prec
        self.mlps = nn.ModuleList([SharedMLP(spec.in_channels + 3, spec.mlp_channels,
                                             cond_dim, prec)])

    def forward(self, features, coords, cond=None):
        s = self.spec
        centers = ops.take(coords, self.prec.fps(coords, s.num_centers))
        grouped = ops.group_relative(centers, coords, features, s.radius, s.num_neighbors)
        return self.mlps[0](grouped, cond).amax(dim=2), centers


class FPModule(nn.Module):
    def __init__(self, spec, cond_dim, prec):
        super().__init__()
        self.mlp = SharedMLP(spec.in_channels, spec.mlp_channels, cond_dim, prec)

    def forward(self, coords, skip, lower_coords, lower_features, cond=None):
        interp = ops.three_nn_interpolate(coords, lower_coords, lower_features)
        return self.mlp(torch.cat([interp, skip], dim=-1), cond)


class _GNLayer(nn.Module):
    """Linear + GroupNorm(32) over the first C - C % 32 channels + swish."""

    def __init__(self, cin, cout, prec):
        super().__init__()
        self.keep = cout - cout % 32
        norm = nn.Module()
        if self.keep:
            norm.group_norm = nn.GroupNorm(32, self.keep, eps=1e-5)
        self.mlp = nn.Sequential(Linear(cin, cout, prec=prec), norm, nn.SiLU())

    def forward(self, x):
        x = self.mlp[0](x)
        if self.keep:
            gn = self.mlp[1].group_norm
            y = ops.group_norm(x[..., :self.keep], 32) * gn.weight + gn.bias
            x = torch.cat([y, x[..., self.keep:]], -1) if self.keep < x.shape[-1] else y
        return ops.swish(x)


class _GNMLP(nn.Module):
    def __init__(self, cin, widths, prec):
        super().__init__()
        self.depth = len(widths)
        for k, oc in enumerate(widths):
            setattr(self, f"shared_mlp_{k}", _GNLayer(cin, oc, prec))
            cin = oc

    def forward(self, x):
        for k in range(self.depth):
            x = getattr(self, f"shared_mlp_{k}")(x)
        return x


class GlobalPnet(nn.Module):
    def __init__(self, in_dim, mlp1, mlp2, prec):
        super().__init__()
        self.mlp1 = _GNMLP(in_dim, mlp1, prec)
        self.mlp2 = _GNMLP(2 * mlp1[-1], mlp2, prec)

    def forward(self, x):
        feat = self.mlp1(x)
        feat = torch.cat([feat, feat.amax(dim=1, keepdim=True).expand_as(feat)], dim=-1)
        return self.mlp2(feat).amax(dim=1)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


class Unet(nn.Module):
    """x [B, N, 3], noise levels t [B], features [B, N, F] -> [B, N, 3]."""

    def __init__(self, cfg: dict, precision: str = "f32"):
        super().__init__()
        model = cfg["model"]
        pvd = model["PVD"]
        self.prec = prec = Precision(precision)
        prec.p_drop = float(model.get("dropout", 0.1))
        plan: Plan = plan_from_config(cfg)
        self.plan = plan
        self.input_dim = model.get("in_dim", 3)
        extra = pvd.get("extra_feature_channels", model.get("extra_feature_channels", 0))
        self.extra = extra
        f_embed = pvd.get("feat_embed_dim", extra)
        self.embed_dim = model.get("time_embed_dim", 64)
        heads = pvd.get("attention_heads", 4)
        use_se = pvd.get("use_se", True)
        self.embed_feats = None
        if f_embed != extra:
            src = self.input_dim if extra == 0 else extra
            self.embed_feats = nn.Sequential(Linear(src, f_embed, prec=prec),
                                             nn.GroupNorm(8, f_embed, eps=1e-5), nn.SiLU(),
                                             Linear(f_embed, f_embed, prec=prec))
        cond_dim = 0
        self.global_pnet = None
        if pvd.get("use_global_embedding", False):
            c = pvd.get("global_embedding_dim", 1024)
            self.global_pnet = GlobalPnet(self.input_dim, (c // 8, c // 4), (c // 2, c), prec)
            cond_dim = c
        e = self.embed_dim
        self.embedf = nn.Sequential(nn.Linear(e, e), nn.LeakyReLU(0.1), nn.Linear(e, e))
        self.sa_layers = nn.ModuleList()
        for stage in plan.sa_stages:
            convs = [PVConv(s, cond_dim, use_se, heads, prec) for s in stage.convs]
            sa = SAModule(stage.sa, cond_dim, prec)
            self.sa_layers.append(nn.Sequential(*convs, sa) if convs else sa)
        self.global_att = LinearAttention(plan.bottleneck_channels, heads, prec)
        self.fp_layers = nn.ModuleList()
        for stage in plan.fp_stages:
            fp = FPModule(stage.fp, cond_dim, prec)
            convs = [PVConv(s, cond_dim, use_se, heads, prec) for s in stage.convs]
            self.fp_layers.append(nn.Sequential(fp, *convs) if convs else fp)
        last = plan.fp_stages[-1]
        head_in = last.convs[-1].out_channels if last.convs else last.fp.mlp_channels[-1]
        self.classifier = nn.Sequential(SharedMLP(head_in, (plan.out_mlp,), 0, prec),
                                        nn.Dropout(), nn.Linear(plan.out_mlp,
                                                                model.get("out_dim", 3)))

    @staticmethod
    def _parts(layer):
        return list(layer) if isinstance(layer, nn.Sequential) else [layer]

    def forward(self, x, t, x_cond=None):
        if x_cond is not None:
            x = torch.cat([x, x_cond], dim=-1)
        coords = x[..., :self.input_dim]
        features = x[..., self.input_dim:]
        if self.embed_feats is not None:
            ef = self.embed_feats
            h = ef[0](coords if self.extra == 0 else features)
            h = ops.group_norm(h, 8) * ef[1].weight + ef[1].bias
            features = ef[3](ops.swish(h))
        cond = self.global_pnet(coords) if self.global_pnet is not None else None
        emb = self.embedf(timestep_embedding(t, self.embed_dim))
        features = torch.cat([coords, features], dim=-1)

        def with_temb(f):
            return torch.cat([f, emb[:, None, :].expand(f.shape[0], f.shape[1], -1)], dim=-1)

        skips, skip_coords = [], []
        cur, cur_coords = features, coords
        for stage, layer in zip(self.plan.sa_stages, self.sa_layers):
            skips.append(cur)
            skip_coords.append(cur_coords)
            if stage.concat_temb:
                cur = with_temb(cur)
            *convs, sa = self._parts(layer)
            for conv in convs:
                cur = conv(cur, cur_coords, cond)
            cur, cur_coords = sa(cur, cur_coords, cond)
        cur = self.global_att(cur)
        for i, layer in enumerate(self.fp_layers):
            fine = skip_coords[-1 - i]
            fp, *convs = self._parts(layer)
            cur = fp(fine, skips[-1 - i], cur_coords, with_temb(cur), cond)
            cur_coords = fine
            for conv in convs:
                cur = conv(cur, cur_coords, cond)
        head, _, out = self.classifier
        return out(self.prec.dropout(head(cur)))
