"""PVCNN2 blocks and the architecture plan (port of
p2p_bridge_tpu/models/pvcnn.py).

The plan builder below (the spec dataclasses, ``create_pvc_layer_params``,
``build_pvcnn2_plan``) is a verbatim copy of the JAX package's pure-Python
one, which cannot be imported without flax; tests pin the copy to the
original for every shipped config.

Replicated quirks (architecture parity with the three shipped configs):
  * Within set-abstraction stages after the first, only the FIRST conv
    block of a stage is created, so ``n_sa_blocks[i>0]`` beyond 1 adds
    nothing.
  * The time embedding is concatenated to the features entering every SA
    stage except the first, and to the coarse features entering every FP
    stage.
  * FP PVConvs never get attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import (
    avg_voxelize,
    ball_query_group,
    batched_take,
    furthest_point_sample,
    nearest_neighbor_interpolate,
    normalize_coords_to_voxels,
    trilinear_devoxelize,
    trilinear_devoxelize_with_mean,
)
from ..ops.conv3d_gn import conv3d_gn
from .modules import SE, AdaGN, GroupNorm, LinearAttention, SharedMLP, Swish


# ======================================================================
# Architecture plan
# ======================================================================
@dataclass(frozen=True)
class PVConvSpec:
    in_channels: int
    out_channels: int
    resolution: int  # voxel resolution; 0 -> plain SharedMLP block
    attention: bool


@dataclass(frozen=True)
class SASpec:
    num_centers: int
    radius: float
    num_neighbors: int
    in_channels: int  # feature channels entering the grouper
    mlp_channels: Tuple[int, ...]  # SharedMLP widths (input is in+3)


@dataclass(frozen=True)
class SAStage:
    convs: Tuple[PVConvSpec, ...]
    sa: SASpec
    concat_temb: bool  # forward concatenates time emb before this stage


@dataclass(frozen=True)
class FPSpec:
    in_channels: int  # interpolated(lower+temb) + skip channels
    mlp_channels: Tuple[int, ...]


@dataclass(frozen=True)
class FPStage:
    fp: FPSpec
    convs: Tuple[PVConvSpec, ...]


@dataclass(frozen=True)
class PVCNN2Plan:
    sa_stages: Tuple[SAStage, ...]
    fp_stages: Tuple[FPStage, ...]
    bottleneck_channels: int
    out_mlp: int
    skip_channels: Tuple[int, ...]  # sa_in_channels, index-aligned with stages


def create_pvc_layer_params(
    npoints: int,
    channels: Sequence[int],
    n_sa_blocks: Sequence[int],
    n_fp_blocks: Sequence[int],
    radius: Sequence[float],
    voxel_resolutions: Sequence[int],
    downsample_factor: int = 4,
    centers: Optional[Sequence[int]] = None,
):
    """Derive raw SA/FP block configs from the YAML config
    (bit-identical port of reference models/pvcnn.py:34-96)."""
    n_centers = []
    sa_blocks = []
    n_channels = len(channels)
    for i in range(n_channels - 1):
        n_centers.append(npoints // downsample_factor ** (i + 1))
        n_c = n_centers[i] if centers is None else centers[i]
        if i != n_channels - 2:
            sa_blocks.append(
                [
                    [channels[i], n_sa_blocks[i], voxel_resolutions[i]],
                    [n_c, radius[i], 32, [channels[i], channels[i + 1]]],
                ]
            )
        else:
            sa_blocks.append(
                [
                    None,
                    [n_c, radius[i], 32, [channels[i], channels[i], channels[i + 1]]],
                ]
            )
    fp_blocks = [
        [[channels[3], channels[3]], [channels[3], n_fp_blocks[3], voxel_resolutions[3]]],
        [[channels[3], channels[3]], [channels[3], n_fp_blocks[2], voxel_resolutions[2]]],
        [[channels[3], channels[2]], [channels[2], n_fp_blocks[1], voxel_resolutions[1]]],
        [
            [channels[2], channels[2], channels[1]],
            [channels[1], n_fp_blocks[0], voxel_resolutions[0]],
        ],
    ]
    return sa_blocks, fp_blocks


def build_pvcnn2_plan(
    npoints: int,
    channels: Sequence[int],
    n_sa_blocks: Sequence[int],
    n_fp_blocks: Sequence[int],
    radius: Sequence[float],
    voxel_resolutions: Sequence[int],
    input_dim: int = 3,
    extra_feature_channels: int = 0,
    embed_dim: int = 64,
    attentions: Sequence[int] = (0, 0, 0, 1),
    out_mlp: int = 128,
    centers: Optional[Sequence[int]] = None,
) -> PVCNN2Plan:
    """Channel bookkeeping of create_sa_components/create_fp_components."""
    sa_blocks, fp_blocks = create_pvc_layer_params(
        npoints, channels, n_sa_blocks, n_fp_blocks, radius, voxel_resolutions,
        centers=centers,
    )

    in_channels = extra_feature_channels + input_dim
    sa_in_channels: List[int] = []
    sa_stages: List[SAStage] = []
    c = 0
    for idx, (conv_configs, sa_configs) in enumerate(sa_blocks):
        k = 0
        sa_in_channels.append(in_channels)
        use_att = bool(attentions[idx]) if attentions is not None else False
        convs: List[PVConvSpec] = []
        extra = in_channels
        if conv_configs is not None:
            out_ch, num_blocks, vres = conv_configs
            for p in range(num_blocks):
                attn = use_att and p == 0
                if c == 0:
                    convs.append(PVConvSpec(in_channels, out_ch, int(vres), attn))
                elif k == 0:
                    convs.append(
                        PVConvSpec(in_channels + embed_dim, out_ch, int(vres), attn)
                    )
                # p >= 1 with c > 0: dropped (reference pvcnn.py:615-618)
                in_channels = out_ch
                k += 1
            extra = in_channels

        num_centers, rad, num_neighbors, mlp_out = sa_configs
        sa_in = extra + (embed_dim if k == 0 else 0)
        sa = SASpec(
            num_centers=int(num_centers),
            radius=float(rad),
            num_neighbors=int(num_neighbors),
            in_channels=sa_in,
            mlp_channels=tuple(int(o) for o in mlp_out),
        )
        in_channels = extra = mlp_out[-1]
        sa_stages.append(
            SAStage(convs=tuple(convs), sa=sa, concat_temb=idx > 0)
        )
        c += 1

    bottleneck = in_channels

    # FP side. Skip connections use sa_in_channels with index 0 forced to
    # the raw input width (unet_pvc.py:129).
    skip = list(sa_in_channels)
    skip[0] = extra_feature_channels + input_dim

    fp_stages: List[FPStage] = []
    for fp_idx, (fp_configs, conv_configs) in enumerate(fp_blocks):
        fp_in = in_channels + skip[-1 - fp_idx] + embed_dim
        fp = FPSpec(in_channels=fp_in, mlp_channels=tuple(fp_configs))
        in_channels = fp_configs[-1]
        convs: List[PVConvSpec] = []
        if conv_configs is not None:
            out_ch, num_blocks, vres = conv_configs
            for _ in range(num_blocks):
                convs.append(PVConvSpec(in_channels, out_ch, int(vres), False))
                in_channels = out_ch
        fp_stages.append(FPStage(fp=fp, convs=tuple(convs)))

    return PVCNN2Plan(
        sa_stages=tuple(sa_stages),
        fp_stages=tuple(fp_stages),
        bottleneck_channels=bottleneck,
        out_mlp=out_mlp,
        skip_channels=tuple(skip),
    )


# ======================================================================
# Blocks
# ======================================================================
class PVConv(nn.Module):
    """Point-voxel convolution: voxelize -> 2 x [3x3x3 conv + GroupNorm |
    AdaGN (+ swish)] -> SE gate -> trilinear devoxelize -> + point-branch
    SharedMLP -> optional linear attention.

    features [B, N, C_in], coords [B, N, 3] -> [B, N, C_out] in ``dtype``.
    Each conv and its norm run as one ``conv3d_gn`` call (inputs in
    ``dtype``, f32 accumulator and statistics), AdaGN folded into a
    per-cloud f32 affine; the SE gate is applied on the points (it
    commutes with the linear devoxelization)."""

    def __init__(self, spec: PVConvSpec, cond_dim: int = 0, dropout: float = 0.1,
                 use_se: bool = True, attn_heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        cin, cout = spec.in_channels, spec.out_channels

        def norm():
            return (AdaGN(cout, cond_dim, dtype=dtype) if cond_dim
                    else GroupNorm(8, cout, eps=1e-5, dtype=dtype))

        layers = [nn.Conv3d(cin, cout, 3, padding=1), norm(), Swish(),
                  nn.Dropout(dropout), nn.Conv3d(cout, cout, 3, padding=1), norm()]
        if use_se:
            layers.append(SE(cout, dtype=dtype))
        self.voxel_layers = nn.Sequential(*layers)
        self.point_features = SharedMLP(cin, (cout,), cond_dim, dtype=dtype)
        if spec.attention:
            self.attn = LinearAttention(cout, heads=attn_heads, dtype=dtype)

    def _conv_gn(self, x, conv, norm, cond, act):
        if isinstance(norm, AdaGN) and cond is not None:
            gamma, beta = norm.affine(cond)
        else:
            gamma, beta = norm.weight, norm.bias
        weight = conv.weight.permute(2, 3, 4, 1, 0).to(self.dtype)  # [3, 3, 3, Cin, Cout]
        return conv3d_gn(x, weight, conv.bias, gamma, beta, groups=8, eps=1e-5, act=act)

    def forward(self, features, coords, cond=None):
        r = self.spec.resolution
        vl = self.voxel_layers
        features = features.to(self.dtype)
        vox, cont = normalize_coords_to_voxels(coords, r)
        grid = avg_voxelize(features.contiguous(), vox, r)
        h = self._conv_gn(grid, vl[0], vl[1], cond, act=True)
        h = vl[3](h)
        h = self._conv_gn(h, vl[4], vl[5], cond, act=False)
        if len(vl) > 6:
            fused, pooled = trilinear_devoxelize_with_mean(h, cont, r)
            fused = fused * vl[6](pooled)[:, None, :]
        else:
            fused = trilinear_devoxelize(h, cont, r)
        fused = fused + self.point_features(features, cond)
        if self.spec.attention:
            fused = self.attn(fused)
        return fused


class PointNetSAModule(nn.Module):
    """Set abstraction: FPS centres -> ball query + group -> SharedMLP ->
    max over the neighbours. Returns (features [B, M, C_out], centres)."""

    def __init__(self, spec: SASpec, cond_dim: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.mlps = nn.ModuleList(
            [SharedMLP(spec.in_channels + 3, spec.mlp_channels, cond_dim, dtype=dtype)])

    def forward(self, features, coords, cond=None):
        s = self.spec
        centers = batched_take(coords, furthest_point_sample(coords, s.num_centers))
        rows = torch.cat([coords.to(features.dtype), features], dim=-1)
        both, _ = ball_query_group(centers.contiguous(), coords.contiguous(),
                                   rows.contiguous(), s.radius, s.num_neighbors)
        rel = both[..., :3] - centers[:, :, None, :].to(both.dtype)
        grouped = torch.cat([rel, both[..., 3:]], dim=-1).to(features.dtype)
        return self.mlps[0](grouped, cond).amax(dim=2), centers


class PointNetFPModule(nn.Module):
    """Feature propagation: 3-NN upsample + skip concat + SharedMLP."""

    def __init__(self, spec: FPSpec, cond_dim: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.mlp = SharedMLP(spec.in_channels, spec.mlp_channels, cond_dim, dtype=dtype)

    def forward(self, coords, skip_features, lower_coords, lower_features, cond=None):
        interp = nearest_neighbor_interpolate(coords.contiguous(), lower_coords.contiguous(),
                                              lower_features.contiguous())
        if skip_features is not None:
            # a bf16 interp beside an f32 skip promotes to f32, as in JAX
            interp = torch.cat([interp, skip_features], dim=-1)
        return self.mlp(interp, cond)
