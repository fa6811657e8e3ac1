"""Configurations as plain nested dicts.

The port reads no YAML on its main path (the card's machine has no
PyYAML). ``PVDS_PUNET`` holds ``configs/PVDS_PUNet.yaml`` (its ``data``,
``diffusion``, ``model``, ``training`` and ``sampling`` sections); a test
keeps the two equal. ``training.amp`` makes the backbone compute in bf16,
as in the JAX package. Only the CLIs read YAML files.
"""

from __future__ import annotations

import copy

PVDS_PUNET = {
    "data": {
        "data_dir": "data/objects/",
        "dataset": "PUNet",
        "augment": True,
        "use_rgb_features": False,
        "workers": 4,
        "npoints": 2048,
        "fast_patches": True,
        "loader": "pool",
        "pool_size": 2048,
    },
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
    "training": {
        "optimizer": {"type": "AdamW", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999,
                      "weight_decay": 1e-5},
        "scheduler": {"type": "constant", "lr_gamma": 0.999},
        "grad_clip": {"enabled": True, "value": 1.0},
        "bs": 32,
        "overfit": False,
        "amp": True,
        "steps": 450_000,
        "accumulation_steps": 1,
        "log_interval": 10,
        "save_interval": 10000,
        "viz_interval": 10000,
        "seed": 42,
    },
    "sampling": {"bs": 32, "num_iter": 8},
}


def pvds_punet() -> dict:
    """A fresh copy of the PVDS_PUNet configuration."""
    return copy.deepcopy(PVDS_PUNET)
