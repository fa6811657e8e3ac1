"""Configurations as plain nested dicts.

The port reads no YAML on its main path (the card's machine has no
PyYAML). ``PVDS_PUNET`` holds the ``data.npoints``, ``diffusion``,
``model`` and ``training.amp`` values of ``configs/PVDS_PUNet.yaml``; a
test keeps the two equal. ``training.amp`` makes the backbone compute in
bf16, as in the JAX package. Only the CLI reads YAML files.
"""

from __future__ import annotations

import copy

PVDS_PUNET = {
    "data": {"npoints": 2048},
    "diffusion": {
        "timesteps": 1000,
        "sampling_timesteps": 10,
        "objective": "pred_noise",
        "schedule": "linear",
        "sampling_strategy": "DDPM",
        "loss_type": "mse",
        "beta_start": 0.0001,
        "beta_end": 0.02,
        "t0": 0.0001,
        "T": 1.0,
        "ot_ode": True,
    },
    "model": {
        "type": "PVD",
        "ema": True,
        "in_dim": 3,
        "extra_feature_channels": 0,
        "out_dim": 3,
        "time_embed_dim": 64,
        "dropout": 0.15,
        "EMA": {"decay": 0.999},
        "PVD": {
            "use_global_embedding": True,
            "global_embedding_dim": 1024,
            "feat_embed_dim": 32,
            "attention_type": "linear",
            "attention_heads": 4,
            "size": "large",
            "attentions": [0, 0, 0, 1],
            "channels": [32, 64, 128, 256, 512],
            "voxel_resolutions": [32, 16, 8, 8],
            "n_sa_blocks": [1, 2, 1, 1],
            "n_fp_blocks": [1, 2, 1, 1],
            "radius": [0.1, 0.2, 0.4, 0.8],
            "out_mlp": 128,
        },
    },
    "training": {"amp": True},
}


def pvds_punet() -> dict:
    """A fresh copy of the PVDS_PUNet configuration."""
    return copy.deepcopy(PVDS_PUNET)
