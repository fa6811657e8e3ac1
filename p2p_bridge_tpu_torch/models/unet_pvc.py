"""PVCNN2 U-Net denoiser backbone (port of p2p_bridge_tpu/models/unet_pvc.py).

x [B, N, 3] noisy coords, x_cond [B, N, F] extra features, t [B] bridge
noise levels -> prediction [B, N, out_dim] f32. Submodule names are the
reference torch ``state_dict`` keys (``sa_layers``, ``fp_layers``,
``embedf``, ``global_pnet``, ``global_att``, ``classifier``...).

``dtype`` is the compute dtype of the JAX module's ``dtype``: every block
computes in it except the time embedding, the feature-embedding
GroupNorm and the classifier's last Linear, which stay f32 as there.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .modules import (
    AdaGN,
    AffineBank,
    Attention,
    GroupNorm,
    Linear,
    LinearAttention,
    Pnet2Stage,
    SharedMLP,
    Swish,
    norm_act,
    time_embed_mlp,
    timestep_embedding,
)
from .pvcnn import PointNetFPModule, PointNetSAModule, PVCNN2Plan, PVConv, build_pvcnn2_plan


class PVCNN2Unet(nn.Module):
    """The epsilon / x0 prediction network."""

    def __init__(self, plan: PVCNN2Plan, input_dim: int = 3, out_dim: int = 3,
                 extra_feature_channels: int = 0, feat_embed_dim: int = 0,
                 embed_dim: int = 64, use_global_embedding: bool = True,
                 global_embedding_dim: int = 1024, attention_type: str = "linear",
                 attention_heads: int = 4, dropout: float = 0.1, use_se: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.plan = plan
        self.dtype = dtype
        self.input_dim = input_dim
        self.extra_feature_channels = extra_feature_channels
        self.embed_dim = embed_dim
        self.use_global_embedding = use_global_embedding

        f_embed = feat_embed_dim or extra_feature_channels
        self.embed_feats = None
        if f_embed != extra_feature_channels:
            src = input_dim if extra_feature_channels == 0 else extra_feature_channels
            # the JAX module's embed_feats_gn has no dtype: f32 out
            self.embed_feats = nn.Sequential(
                Linear(src, f_embed, dtype=dtype), GroupNorm(8, f_embed, eps=1e-5, dtype=None),
                Swish(), Linear(f_embed, f_embed, dtype=dtype))

        cond_dim = 0
        if use_global_embedding:
            c = global_embedding_dim
            self.global_pnet = Pnet2Stage(input_dim, (c // 8, c // 4), (c // 2, c), dtype)
            cond_dim = c
        self.embedf = time_embed_mlp(embed_dim)

        def pvconv(spec):
            return PVConv(spec, cond_dim=cond_dim, dropout=dropout, use_se=use_se,
                          attn_heads=attention_heads, dtype=dtype)

        sa_layers = []
        for stage in plan.sa_stages:
            sa = PointNetSAModule(stage.sa, cond_dim, dtype)
            convs = [pvconv(s) for s in stage.convs]
            sa_layers.append(nn.Sequential(*convs, sa) if convs else sa)
        self.sa_layers = nn.ModuleList(sa_layers)

        kind = attention_type.lower()
        self.global_att = None
        if kind == "linear":
            self.global_att = LinearAttention(plan.bottleneck_channels, heads=attention_heads,
                                              dtype=dtype)
        elif kind == "flash":
            # no dtype, as the JAX module: full attention computes in f32
            self.global_att = Attention(plan.bottleneck_channels, heads=attention_heads)

        fp_layers = []
        for stage in plan.fp_stages:
            fp = PointNetFPModule(stage.fp, cond_dim, dtype)
            convs = [pvconv(s) for s in stage.convs]
            fp_layers.append(nn.Sequential(fp, *convs) if convs else fp)
        self.fp_layers = nn.ModuleList(fp_layers)

        last = plan.fp_stages[-1]
        head_in = last.convs[-1].out_channels if last.convs else last.fp.mlp_channels[-1]
        # the last Linear stays f32: the regression target is full precision
        self.classifier = nn.Sequential(
            SharedMLP(head_in, (plan.out_mlp,), dtype=dtype), nn.Dropout(dropout),
            nn.Linear(plan.out_mlp, out_dim))
        adagns = [m for m in self.modules() if isinstance(m, AdaGN)]
        if adagns:  # every AdaGN's affine of the one global embedding at once
            bank = AffineBank(adagns)
            for m in adagns:
                m.bank = bank

    @staticmethod
    def _split(layer, module_type):
        """(the SA/FP module, its PVConvs) of one stage."""
        if isinstance(layer, module_type):
            return layer, []
        mods = list(layer)
        if module_type is PointNetSAModule:
            return mods[-1], mods[:-1]
        return mods[0], mods[1:]

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                x_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x_cond is not None:
            x = torch.cat([x, x_cond.to(x.dtype)], dim=-1)
        C = x.shape[-1]
        if C != self.input_dim + self.extra_feature_channels:
            raise ValueError(f"input dim {C}, expected "
                             f"{self.input_dim + self.extra_feature_channels}")
        # a slice of the conditioned input: the kernels take contiguous tensors
        coords = x[..., :self.input_dim].contiguous()
        features = x[..., self.input_dim:]
        if self.embed_feats is not None:
            src = coords if self.extra_feature_channels == 0 else features
            linear, norm, _, out = self.embed_feats
            features = out(norm_act(norm, linear(src)))

        cond = self.global_pnet(coords) if self.use_global_embedding else None
        temb = self.embedf(timestep_embedding(t, self.embed_dim))
        # f32 coords beside bf16 features promote to f32, as in JAX
        features = torch.cat([coords, features], dim=-1)

        def with_temb(feat):
            tb = temb[:, None, :].expand(feat.shape[0], feat.shape[1], -1)
            return torch.cat([feat, tb.to(feat.dtype)], dim=-1)

        skip_features, skip_coords = [], []
        cur, cur_coords = features, coords
        for stage, layer in zip(self.plan.sa_stages, self.sa_layers):
            skip_features.append(cur)
            skip_coords.append(cur_coords)
            if stage.concat_temb:
                cur = with_temb(cur)
            sa, convs = self._split(layer, PointNetSAModule)
            for conv in convs:
                cur = conv(cur, cur_coords, cond)
            cur, cur_coords = sa(cur, cur_coords, cond)

        if self.global_att is not None:
            cur = self.global_att(cur)

        for fp_idx, layer in enumerate(self.fp_layers):
            fine_coords = skip_coords[-1 - fp_idx]
            fp, convs = self._split(layer, PointNetFPModule)
            cur = fp(fine_coords, skip_features[-1 - fp_idx], cur_coords,
                     with_temb(cur), cond)
            cur_coords = fine_coords
            for conv in convs:
                cur = conv(cur, cur_coords, cond)

        head, drop, out = self.classifier
        return out(drop(head(cur)).float())


def compute_dtype(cfg) -> torch.dtype:
    """bf16 when ``model.compute_dtype`` is "bf16", or is unset and
    ``training.amp`` is true; else f32 (the JAX package's rule)."""
    amp = cfg.get("training", {}).get("amp", False)
    name = cfg["model"].get("compute_dtype", "bf16" if amp else "f32")
    return torch.bfloat16 if name == "bf16" else torch.float32


def plan_from_config(cfg) -> PVCNN2Plan:
    """The architecture plan of a reference-style config (nested dict)."""
    model_cfg = cfg["model"]
    pvd = model_cfg["PVD"]
    extra = pvd.get("extra_feature_channels", model_cfg.get("extra_feature_channels", 0))
    return build_pvcnn2_plan(
        npoints=cfg["data"]["npoints"],
        channels=list(pvd["channels"]),
        n_sa_blocks=list(pvd["n_sa_blocks"]),
        n_fp_blocks=list(pvd["n_fp_blocks"]),
        radius=list(pvd["radius"]),
        voxel_resolutions=list(pvd["voxel_resolutions"]),
        input_dim=model_cfg.get("in_dim", 3),
        extra_feature_channels=pvd.get("feat_embed_dim", extra),
        embed_dim=model_cfg.get("time_embed_dim", 64),
        attentions=list(pvd["attentions"]),
        out_mlp=pvd.get("out_mlp", 128),
        centers=list(pvd["centers"]) if "centers" in pvd else None,
    )


def build_unet_from_config(cfg) -> PVCNN2Unet:
    """The backbone of a reference-style config (nested dict), computing
    in :func:`compute_dtype`."""
    model_cfg = cfg["model"]
    pvd = model_cfg["PVD"]
    extra = pvd.get("extra_feature_channels", model_cfg.get("extra_feature_channels", 0))
    return PVCNN2Unet(
        plan=plan_from_config(cfg),
        input_dim=model_cfg.get("in_dim", 3),
        out_dim=model_cfg.get("out_dim", 3),
        extra_feature_channels=extra,
        feat_embed_dim=pvd.get("feat_embed_dim", extra),
        embed_dim=model_cfg.get("time_embed_dim", 64),
        use_global_embedding=pvd.get("use_global_embedding", False),
        global_embedding_dim=pvd.get("global_embedding_dim", 1024),
        attention_type=pvd.get("attention_type", "linear"),
        attention_heads=pvd.get("attention_heads", 4),
        dropout=model_cfg.get("dropout", 0.1),
        use_se=pvd.get("use_se", True),
        dtype=compute_dtype(cfg),
    )


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter with PyTorch's default initialisation from
    ``generator``: Linear/Conv weights kaiming-uniform(a=sqrt(5)), biases
    uniform(+-1/sqrt(fan_in)), GroupNorm ones/zeros, and AdaGN's
    conditioning bias [1..., 0...] (identity scale, zero shift)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5, generator=generator)
                if m.bias is not None:
                    fan_in = m.weight[0].numel()
                    bound = 1.0 / fan_in ** 0.5
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for m in model.modules():
            if isinstance(m, AdaGN):
                C = m.norm.num_channels
                m.emd.bias[:C] = 1.0
                m.emd.bias[C:] = 0.0
    return model
