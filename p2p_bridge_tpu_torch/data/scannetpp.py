"""ScanNetPP room-batch npz dataset (copy of
p2p_bridge_tpu/data/scannetpp.py; tests hold the two equal).

Port of reference dataloaders/scannetpp.py:56-212 with one deliberate
fix: the released reference crosses the npz arrays when filling the
output dict (``noisy_points <- points_clean`` and vice versa,
scannetpp.py:206-208), which inverts the bridge direction relative to
the PUNet path and to inference (SURVEY.md §2.6). Here the physically
correct mapping (clean_points <- "clean" array) is the default;
``legacy_key_swap=True`` reproduces the reference's released behavior
for checkpoint-parity experiments.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from .transforms import random_rotate_horizontally


def _read_split(splits_path: str, name: str) -> List[str]:
    with open(os.path.join(splits_path, name), "r") as f:
        return f.read().splitlines()


class ScanNetPP:
    """Per-scene spherical-batch npz files: keys clean/noisy (xyz + rgb
    cols 3:), optional fp16 'features' (DINO), optional center/scale."""

    def __init__(
        self,
        root: str,
        mode: str = "training",
        additional_features: bool = False,
        augment: bool = False,
        transform: Optional[Callable] = None,
        splits_path: str = "splits",
        legacy_key_swap: bool = False,
        seed: int = 0,
    ):
        self.root = root
        self.additional_features = additional_features
        self.augment = augment
        self.transform = transform
        self.legacy_key_swap = legacy_key_swap
        self.seed = seed

        scans = _read_split(
            splits_path, "snpp_train.txt" if mode == "training" else "snpp_val.txt"
        )
        folders = [
            f for f in sorted(os.listdir(root))
            if os.path.isdir(os.path.join(root, f)) and f in scans
        ]
        self.scene_batches = []
        for folder in folders:
            files = sorted(
                f for f in os.listdir(os.path.join(root, folder))
                if f.startswith("points") and f.endswith(".npz")
            )
            for points in files:
                self.scene_batches.append(
                    {"scene": folder, "npz": os.path.join(root, folder, points)}
                )

    def __len__(self):
        return len(self.scene_batches)

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        batch = {}
        # retry-on-corrupt-file robustness (scannetpp.py:142-152)
        for _ in range(10):
            try:
                data = self.scene_batches[index]
                d = np.load(data["npz"])
                clean = np.asarray(d["clean"], np.float32)
                noisy = np.asarray(d["noisy"], np.float32)
                break
            except Exception:
                index = int(rng.integers(0, len(self)))
        else:
            raise RuntimeError("too many corrupt npz files")

        points_noisy = noisy[:, :3].copy()
        points_clean = clean[:, :3].copy()
        if noisy.shape[1] > 3:
            batch["noisy_colors"] = noisy[:, 3:]
        if clean.shape[1] > 3:
            batch["clean_colors"] = clean[:, 3:]
        if self.additional_features:
            batch["noisy_features"] = np.asarray(d["features"], np.float32)

        if "center" not in d:
            center = points_noisy.mean(axis=0)
            points_noisy -= center
            points_clean -= center
        else:
            center = np.asarray(d["center"])
        if "scale" not in d:
            scale = np.linalg.norm(points_noisy, axis=1).max()
            points_noisy /= scale
            points_clean /= scale
        else:
            scale = np.asarray(d["scale"])

        if self.augment and rng.random() < 0.5:
            points_noisy, theta = random_rotate_horizontally(points_noisy, rng=rng)
            points_clean, _ = random_rotate_horizontally(points_clean, theta=theta)

        perm = rng.permutation(points_noisy.shape[0])
        points_noisy = points_noisy[perm]
        points_clean = points_clean[perm]
        for k in ("noisy_colors", "clean_colors", "noisy_features"):
            if k in batch:
                batch[k] = batch[k][perm]

        if self.transform is not None:
            points_noisy = self.transform(points_noisy)
            points_clean = self.transform(points_clean)

        if self.legacy_key_swap:
            points_noisy, points_clean = points_clean, points_noisy

        batch["idx"] = index
        batch["noisy_points"] = points_noisy.astype(np.float32)
        batch["clean_points"] = points_clean.astype(np.float32)
        batch["center"] = center
        batch["scale"] = scale
        return batch


class NPZFolderTest:
    """Inference-time folder of npz room batches
    (reference scannetpp.py:12-50): returns noisy points + features only."""

    def __init__(self, root: str, features: Optional[str] = None):
        self.root = root
        self.features = features
        self.files = sorted(f for f in os.listdir(root) if f.endswith(".npz"))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        d = np.load(os.path.join(self.root, self.files[index]))
        noisy = np.asarray(d["noisy"], np.float32)
        out = {
            "noisy_points": noisy[:, :3],
            "idx": index,
            "name": self.files[index][:-4],
        }
        if noisy.shape[1] > 3:
            out["noisy_colors"] = noisy[:, 3:]
        if self.features and self.features in d:
            out["noisy_features"] = np.asarray(d[self.features], np.float32)
        if "center" in d:
            out["center"] = np.asarray(d["center"])
        if "scale" in d:
            out["scale"] = np.asarray(d["scale"])
        return out
