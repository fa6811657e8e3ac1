"""The PVCNN2 architecture plan of a configuration: a frozen copy of the
channel bookkeeping of the P2P-Bridge reference (``models/pvcnn.py``
``create_pvc_layer_params`` and the SA / FP component builders).

Replicated quirks of the published model: within set-abstraction stages
after the first, only the first conv block of a stage is created; the time
embedding is concatenated to the features entering every SA stage but the
first and to the coarse features entering every FP stage; FP PVConvs never
get attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class PVConvSpec:
    in_channels: int
    out_channels: int
    resolution: int
    attention: bool


@dataclass(frozen=True)
class SASpec:
    num_centers: int
    radius: float
    num_neighbors: int
    in_channels: int
    mlp_channels: Tuple[int, ...]


@dataclass(frozen=True)
class SAStage:
    convs: Tuple[PVConvSpec, ...]
    sa: SASpec
    concat_temb: bool


@dataclass(frozen=True)
class FPSpec:
    in_channels: int
    mlp_channels: Tuple[int, ...]


@dataclass(frozen=True)
class FPStage:
    fp: FPSpec
    convs: Tuple[PVConvSpec, ...]


@dataclass(frozen=True)
class Plan:
    sa_stages: Tuple[SAStage, ...]
    fp_stages: Tuple[FPStage, ...]
    bottleneck_channels: int
    out_mlp: int
    skip_channels: Tuple[int, ...]


def _layer_params(npoints, channels, n_sa_blocks, n_fp_blocks, radius, voxel_resolutions,
                  centers=None, downsample_factor=4):
    sa_blocks = []
    for i in range(len(channels) - 1):
        n_c = npoints // downsample_factor ** (i + 1) if centers is None else centers[i]
        if i != len(channels) - 2:
            sa_blocks.append([[channels[i], n_sa_blocks[i], voxel_resolutions[i]],
                              [n_c, radius[i], 32, [channels[i], channels[i + 1]]]])
        else:
            sa_blocks.append([None, [n_c, radius[i], 32,
                                     [channels[i], channels[i], channels[i + 1]]]])
    fp_blocks = [
        [[channels[3], channels[3]], [channels[3], n_fp_blocks[3], voxel_resolutions[3]]],
        [[channels[3], channels[3]], [channels[3], n_fp_blocks[2], voxel_resolutions[2]]],
        [[channels[3], channels[2]], [channels[2], n_fp_blocks[1], voxel_resolutions[1]]],
        [[channels[2], channels[2], channels[1]],
         [channels[1], n_fp_blocks[0], voxel_resolutions[0]]],
    ]
    return sa_blocks, fp_blocks


def build_plan(npoints: int, channels: Sequence[int], n_sa_blocks: Sequence[int],
               n_fp_blocks: Sequence[int], radius: Sequence[float],
               voxel_resolutions: Sequence[int], input_dim: int = 3,
               extra_feature_channels: int = 0, embed_dim: int = 64,
               attentions: Sequence[int] = (0, 0, 0, 1), out_mlp: int = 128,
               centers: Optional[Sequence[int]] = None) -> Plan:
    sa_blocks, fp_blocks = _layer_params(npoints, channels, n_sa_blocks, n_fp_blocks, radius,
                                         voxel_resolutions, centers)
    in_channels = extra_feature_channels + input_dim
    sa_in, sa_stages = [], []
    for idx, (conv_cfg, sa_cfg) in enumerate(sa_blocks):
        k = 0
        sa_in.append(in_channels)
        use_att = bool(attentions[idx])
        convs = []
        extra = in_channels
        if conv_cfg is not None:
            out_ch, num_blocks, vres = conv_cfg
            for p in range(num_blocks):
                attn = use_att and p == 0
                if idx == 0:
                    convs.append(PVConvSpec(in_channels, out_ch, int(vres), attn))
                elif k == 0:
                    convs.append(PVConvSpec(in_channels + embed_dim, out_ch, int(vres), attn))
                in_channels = out_ch
                k += 1
            extra = in_channels
        n_c, rad, n_nb, mlp_out = sa_cfg
        sa = SASpec(int(n_c), float(rad), int(n_nb), extra + (embed_dim if k == 0 else 0),
                    tuple(int(o) for o in mlp_out))
        in_channels = mlp_out[-1]
        sa_stages.append(SAStage(tuple(convs), sa, idx > 0))
    bottleneck = in_channels
    skip = list(sa_in)
    skip[0] = extra_feature_channels + input_dim
    fp_stages = []
    for fp_idx, (fp_cfg, conv_cfg) in enumerate(fp_blocks):
        fp = FPSpec(in_channels + skip[-1 - fp_idx] + embed_dim, tuple(fp_cfg))
        in_channels = fp_cfg[-1]
        convs = []
        out_ch, num_blocks, vres = conv_cfg
        for _ in range(num_blocks):
            convs.append(PVConvSpec(in_channels, out_ch, int(vres), False))
            in_channels = out_ch
        fp_stages.append(FPStage(fp, tuple(convs)))
    return Plan(tuple(sa_stages), tuple(fp_stages), bottleneck, out_mlp, tuple(skip))


def plan_from_config(cfg: dict) -> Plan:
    model = cfg["model"]
    pvd = model["PVD"]
    extra = pvd.get("extra_feature_channels", model.get("extra_feature_channels", 0))
    return build_plan(
        npoints=cfg["data"]["npoints"], channels=list(pvd["channels"]),
        n_sa_blocks=list(pvd["n_sa_blocks"]), n_fp_blocks=list(pvd["n_fp_blocks"]),
        radius=list(pvd["radius"]), voxel_resolutions=list(pvd["voxel_resolutions"]),
        input_dim=model.get("in_dim", 3), extra_feature_channels=pvd.get("feat_embed_dim", extra),
        embed_dim=model.get("time_embed_dim", 64), attentions=list(pvd["attentions"]),
        out_mlp=pvd.get("out_mlp", 128),
        centers=list(pvd["centers"]) if "centers" in pvd else None)
