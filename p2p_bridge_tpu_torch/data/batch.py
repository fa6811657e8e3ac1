"""Batch adaptation: dataset dicts -> bridge inputs (copy of
p2p_bridge_tpu/data/batch.py on dict configurations; tests hold the two
equal).

Port of get_data_batch (reference: models/train_utils.py:140-189) to the
channels-last layout: all outputs are [B, N, C] numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np


def get_data_batch(
    batch: Dict[str, np.ndarray], cfg: dict, align_fn: Optional[Callable] = None
) -> Dict[str, Optional[np.ndarray]]:
    """Map dataset keys to {x_gt, x_start, x_cond} ([B, N, C] each).

    For PUNet, optionally EMD-aligns the clean points to the noisy points
    (train.py:73-85); the training step does it on the device instead."""
    data = cfg["data"]
    clean = np.asarray(batch["clean_points"], np.float32)
    noisy = np.asarray(batch["noisy_points"], np.float32)

    features = None
    if data["dataset"] != "PUNet" and not data.get("unconditional", False):
        if "noisy_features" in batch:
            features = np.asarray(batch["noisy_features"], np.float32)

    if data["dataset"] == "PUNet" and align_fn is not None:
        clean = np.asarray(align_fn(noisy, clean))

    if data.get("use_rgb_features", False) and "noisy_colors" in batch:
        colors = np.asarray(batch["noisy_colors"], np.float32)
        features = colors if features is None else np.concatenate([colors, features], -1)

    return {"x_gt": clean, "x_start": noisy, "x_cond": features}
