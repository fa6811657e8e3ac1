"""DINOv2 feature lifting: project per-frame image features onto points
(copy of p2p_bridge_tpu/data/image_features.py; tests hold the two equal).

Port of the reference's offline feature-extraction pipeline
(reference: data/processing/image_features.py:21-328 +
data/extract_image_features_snpp.py): for each RGB-D frame, compute
dense patch features, project the scene points into the frame with
occlusion filtering, accumulate a per-point running mean, and finally
interpolate features for points never observed.

The geometry (projection, occlusion z-buffer, running mean, missing-
feature interpolation) is pure numpy below. The image encoder is
PLUGGABLE: the reference pulls DINOv2 from torch.hub, which needs
network access; this package never fetches weights. Pass any callable
``image -> [h, w, C] features`` — e.g. transformers' Dinov2Model from a
local checkpoint — to ``process_scene``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("p2pb")


def load_dino_extractor(model_name: str = "facebook/dinov2-small",
                        device: str = "cpu") -> Callable:
    """Build an image->patch-features extractor from a local HF
    checkpoint (replaces torch.hub dinov2, image_features.py:21-31).

    Raises if the weights are not available locally: ``local_files_only``
    keeps transformers from ever fetching them."""
    import torch
    from transformers import AutoImageProcessor, AutoModel

    processor = AutoImageProcessor.from_pretrained(model_name, local_files_only=True)
    model = AutoModel.from_pretrained(model_name, local_files_only=True).to(device).eval()
    patch = model.config.patch_size

    @torch.no_grad()
    def extract(image: np.ndarray) -> np.ndarray:
        """image [H, W, 3] uint8 -> [h, w, C] float features."""
        inputs = processor(images=image, return_tensors="pt").to(device)
        out = model(**inputs).last_hidden_state[0, 1:]  # drop CLS
        H = inputs["pixel_values"].shape[2] // patch
        W = inputs["pixel_values"].shape[3] // patch
        return out.reshape(H, W, -1).cpu().numpy()

    return extract


def load_descriptor_extractor(feat_dim: int = 384, patch: int = 14,
                              seed: int = 0) -> Callable:
    """Built-in torch-free patch descriptor: a fixed random projection of
    per-patch color statistics and oriented gradient histograms into
    ``feat_dim`` channels.

    This is NOT DINOv2 — it is the self-contained default so the whole
    lifting pipeline (projection, occlusion, accumulation,
    interpolation, training with point_features conditioning) runs
    end-to-end without network access or pretrained weights. Swap in
    ``load_dino_extractor`` (local HF checkpoint) for semantic features.
    The descriptor is deterministic (fixed seed) so train/infer agree.
    """
    rng = np.random.default_rng(seed)
    raw_dim = 3 + 3 + 8  # mean rgb, std rgb, 8-bin gradient histogram
    proj = rng.normal(size=(raw_dim, feat_dim)).astype(np.float32)
    proj /= np.sqrt(raw_dim)

    def extract(image: np.ndarray) -> np.ndarray:
        """image [H, W, 3] uint8 -> [h, w, feat_dim] float features."""
        img = np.asarray(image, np.float32) / 255.0
        H, W = img.shape[:2]
        h, w = H // patch, W // patch
        img = img[: h * patch, : w * patch]
        blocks = img.reshape(h, patch, w, patch, 3).transpose(0, 2, 1, 3, 4)
        mean = blocks.mean(axis=(2, 3))            # [h, w, 3]
        std = blocks.std(axis=(2, 3))              # [h, w, 3]
        gray = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
        gy, gx = np.gradient(gray)
        mag = np.sqrt(gx * gx + gy * gy)
        ang = np.arctan2(gy, gx)  # [-pi, pi]
        bins = np.clip(((ang + np.pi) / (2 * np.pi) * 8).astype(np.int32),
                       0, 7)
        hog = np.zeros((h, w, 8), np.float32)
        bb = bins.reshape(h, patch, w, patch).transpose(0, 2, 1, 3)
        mm = mag.reshape(h, patch, w, patch).transpose(0, 2, 1, 3)
        for k in range(8):
            hog[..., k] = np.where(bb == k, mm, 0.0).sum(axis=(2, 3))
        hog /= hog.sum(axis=-1, keepdims=True) + 1e-6
        raw = np.concatenate([mean, std, hog], axis=-1)  # [h, w, raw_dim]
        return raw @ proj

    return extract


def project_points(
    points: np.ndarray, intrinsics: np.ndarray, world_to_cam: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Project world points into a pinhole camera
    (image_features.py:114-146).

    Args:
      points: [N, 3] world coordinates.
      intrinsics: [3, 3] K matrix.
      world_to_cam: [4, 4] extrinsics.
    Returns:
      (uv [N, 2] pixel coordinates, depth [N] camera-space z)
    """
    homo = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    cam = (world_to_cam @ homo.T).T[:, :3]
    depth = cam[:, 2]
    uvw = (intrinsics @ cam.T).T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-9)
    return uv, depth


def visible_mask_with_occlusion(
    uv: np.ndarray,
    depth: np.ndarray,
    width: int,
    height: int,
    zbuf_downscale: int = 8,
    depth_tol: float = 0.05,
    frame_depth: Optional[np.ndarray] = None,
) -> np.ndarray:
    """In-frustum + occlusion filtering (image_features.py:147-192).

    With a sensor depth map, a point is visible when its projected depth
    matches the measured depth within ``depth_tol`` (relative). Without
    one, a coarse z-buffer over ``zbuf_downscale``-pixel cells keeps
    points within tolerance of the nearest point in their cell.
    """
    inside = (
        (uv[:, 0] >= 0) & (uv[:, 0] < width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < height)
        & (depth > 0)
    )
    visible = inside.copy()
    idx = np.where(inside)[0]
    if len(idx) == 0:
        return visible
    if frame_depth is not None:
        u = uv[idx, 0].astype(np.int64).clip(0, width - 1)
        v = uv[idx, 1].astype(np.int64).clip(0, height - 1)
        measured = frame_depth[v, u]
        ok = (measured > 0) & (np.abs(depth[idx] - measured) <= depth_tol * measured)
        visible[idx] = ok
        return visible
    # coarse z-buffer
    gw = (width + zbuf_downscale - 1) // zbuf_downscale
    gh = (height + zbuf_downscale - 1) // zbuf_downscale
    cell = (
        (uv[idx, 1] // zbuf_downscale).astype(np.int64).clip(0, gh - 1) * gw
        + (uv[idx, 0] // zbuf_downscale).astype(np.int64).clip(0, gw - 1)
    )
    zbuf = np.full(gw * gh, np.inf)
    np.minimum.at(zbuf, cell, depth[idx])
    ok = depth[idx] <= zbuf[cell] * (1.0 + depth_tol)
    visible[idx] = ok
    return visible


class FeatureAccumulator:
    """Per-point running-mean of lifted features
    (image_features.py:254-281)."""

    def __init__(self, num_points: int, feat_dim: int):
        self.sums = np.zeros((num_points, feat_dim), np.float64)
        self.counts = np.zeros(num_points, np.int64)

    def update(self, point_idx: np.ndarray, feats: np.ndarray) -> None:
        np.add.at(self.sums, point_idx, feats.astype(np.float64))
        np.add.at(self.counts, point_idx, 1)

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        mask = self.counts > 0
        out = np.zeros_like(self.sums, dtype=np.float32)
        out[mask] = (self.sums[mask] / self.counts[mask, None]).astype(np.float32)
        return out, mask


def interpolate_missing_features(
    points: np.ndarray, features: np.ndarray, observed: np.ndarray, k: int = 3
) -> np.ndarray:
    """Fill never-observed points by inverse-distance kNN over observed
    ones (image_features.py:282-328)."""
    from scipy.spatial import cKDTree

    if observed.all() or not observed.any():
        return features
    tree = cKDTree(points[observed])
    obs_feats = features[observed]
    missing = np.where(~observed)[0]
    d, idx = tree.query(points[missing], k=min(k, int(observed.sum())), workers=-1)
    d = np.atleast_2d(d)
    idx = np.atleast_2d(idx)
    w = 1.0 / np.maximum(d, 1e-8)
    w = w / w.sum(axis=1, keepdims=True)
    features = features.copy()
    features[missing] = np.einsum("mk,mkc->mc", w, obs_feats[idx]).astype(np.float32)
    return features


def lift_frame_features(
    points: np.ndarray,
    frame_feats: np.ndarray,
    intrinsics: np.ndarray,
    world_to_cam: np.ndarray,
    image_size: Tuple[int, int],
    accumulator: FeatureAccumulator,
    frame_depth: Optional[np.ndarray] = None,
) -> int:
    """One frame: project, filter, bilinear-free nearest-patch lookup,
    accumulate (image_features.py:193-253). Returns #points updated."""
    width, height = image_size
    uv, depth = project_points(points, intrinsics, world_to_cam)
    visible = visible_mask_with_occlusion(
        uv, depth, width, height, frame_depth=frame_depth
    )
    idx = np.where(visible)[0]
    if len(idx) == 0:
        return 0
    h, w = frame_feats.shape[:2]
    fu = (uv[idx, 0] / width * w).astype(np.int64).clip(0, w - 1)
    fv = (uv[idx, 1] / height * h).astype(np.int64).clip(0, h - 1)
    accumulator.update(idx, frame_feats[fv, fu])
    return len(idx)


def process_scene(
    points: np.ndarray,
    frames: List[Dict],
    extractor: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    feat_dim: Optional[int] = None,
) -> np.ndarray:
    """Lift features from all frames onto the scene points
    (image_features.py:329+).

    Args:
      points: [N, 3] world coordinates.
      frames: list of dicts with keys: "image" [H, W, 3] uint8,
        "intrinsics" [3, 3], "world_to_cam" [4, 4],
        optional "depth" [H, W].
      extractor: image -> [h, w, C] dense features.
    Returns:
      [N, C] float32 per-point features (missing ones interpolated).
    """
    if extractor is None:
        extractor = load_descriptor_extractor(feat_dim or 384)
    acc = None
    for frame in frames:
        feats = extractor(frame["image"])
        if acc is None:
            acc = FeatureAccumulator(len(points), feats.shape[-1])
        H, W = frame["image"].shape[:2]
        n = lift_frame_features(
            points, feats, frame["intrinsics"], frame["world_to_cam"],
            (W, H), acc, frame_depth=frame.get("depth"),
        )
        logger.debug("frame updated %d points", n)
    if acc is None:
        raise ValueError("no frames given")
    features, observed = acc.result()
    return interpolate_missing_features(points, features, observed)
