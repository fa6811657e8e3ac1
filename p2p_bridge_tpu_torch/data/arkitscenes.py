"""ARKitScenes npz dataset (copy of p2p_bridge_tpu/data/arkitscenes.py;
tests hold the two equal; reference: dataloaders/arkitscenes.py:1-108).

npz keys: "faro" (high-res scan) and "iphone" (low-res scan), plus
optional per-point features. The reference returns hr_points/lr_points;
we additionally emit the clean_points/noisy_points aliases that
``get_data_batch`` consumes (the as-committed reference ARKit training
path is stale on exactly this mismatch — SURVEY.md §2.6)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .transforms import random_rotate_horizontally


class ArkitNPZ:
    def __init__(
        self,
        root: str,
        mode: str = "training",
        features: Optional[str] = None,
        augment: bool = False,
        seed: int = 0,
    ):
        self.root = root
        self.features = features
        self.augment = augment
        self.seed = seed
        base = os.path.join(root, mode) if os.path.isdir(os.path.join(root, mode)) else root
        self.scene_batches = []
        for folder in sorted(os.listdir(base)):
            fp = os.path.join(base, folder)
            if os.path.isdir(fp):
                for f in sorted(os.listdir(fp)):
                    if f.startswith("points") and f.endswith(".npz"):
                        self.scene_batches.append(
                            {"scene": folder, "npz": os.path.join(fp, f)}
                        )
            elif folder.endswith(".npz"):
                self.scene_batches.append({"scene": folder[:-4], "npz": fp})

    def __len__(self):
        return len(self.scene_batches)

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        batch = {}
        data = self.scene_batches[index % len(self.scene_batches)]
        d = np.load(data["npz"])
        faro = np.asarray(d["faro"], np.float32)
        iphone = np.asarray(d["iphone"], np.float32)

        points_iphone = iphone[:, :3].copy()
        points_faro = faro[:, :3].copy()
        if iphone.shape[1] > 3:
            batch["noisy_colors"] = iphone[:, 3:]
        if faro.shape[1] > 3:
            batch["clean_colors"] = faro[:, 3:]
        if self.features is not None and self.features in d:
            batch["noisy_features"] = np.asarray(d[self.features], np.float32)

        center = points_iphone.mean(axis=0)
        points_iphone -= center
        points_faro -= center
        scale = np.linalg.norm(points_iphone, axis=1).max()
        points_iphone /= scale
        points_faro /= scale

        if self.augment and rng.random() < 0.5:
            points_iphone, theta = random_rotate_horizontally(points_iphone, rng=rng)
            points_faro, _ = random_rotate_horizontally(points_faro, theta=theta)

        batch["idx"] = index
        batch["hr_points"] = points_faro
        batch["lr_points"] = points_iphone
        # aliases consumed by get_data_batch (x_gt <- clean, x_start <- noisy)
        batch["clean_points"] = points_faro
        batch["noisy_points"] = points_iphone
        batch["center"] = center
        batch["scale"] = scale
        return batch
