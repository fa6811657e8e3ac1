"""Room-scale patch denoising (port of p2p_bridge_tpu/rooms.py).

  * FPS seed centres over the whole room (host ``bucket_fps``),
  * KD-tree radius neighbourhoods (scipy),
  * each neighbourhood padded with jittered duplicates, or FPS-split, to
    exactly ``patch_size`` points,
  * bridge sampling of ``batch_size`` patches at a time on the bridge's
    device, the last batch padded with repeats so every batch has one
    shape; the conditioning channels (colours, features) are copied to the
    device once a room and each batch's rows gathered there,
  * overlap-averaged recomposition in the native host runtime.

The host work (seeding, patching, normalisation, recomposition) is numpy,
step for step the JAX package's, so the two produce the same patches from
the same room. ``bucket_fps`` ignores its seed there, and so here: the
FPS split of a neighbourhood of n >= patch_size points yields
``n // patch_size + 1`` identical patches (kept, so the outputs agree).

Spans (``utils/spans.py``, in a profiler's trace only): ``rooms.seed``
(the seeding FPS and the KD-tree query), ``rooms.patches`` (a call of
``create_patches``) holding one ``rooms.split_fps`` per split FPS,
``rooms.batches`` (the batch loop) holding one ``rooms.features`` (the
room's conditioning copied to the device, where a call has any) and one
``rooms.upload`` per batch.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from .metrics.chamfer import chamfer_distance
from .ops.fps import bucket_fps
from .parallel.mesh import shard_batch
from .runtime import accumulate_running_mean, finalize_running_mean, get_lib
from .utils.device import resolve_device
from .utils.spans import span

logger = logging.getLogger("p2pb")


def create_patches(
    room_points: np.ndarray,
    patch_size: int,
    idxs_radius_patches: List[np.ndarray],
    room_colors: Optional[np.ndarray] = None,
    room_features: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
):
    """Fixed-size patches from ragged radius neighbourhoods.

    A neighbourhood smaller than ``patch_size`` is padded with jittered
    duplicates (noise scale 1% of its bounding-box diagonal); a larger one
    is FPS-split into n // patch_size + 1 subsets of exactly patch_size
    points.

    Returns (xyz [P, S, 3] f32, rgb, feats, idxs [P, S], cut_list [P]).
    """
    with span("rooms.patches"):
        rng = rng or np.random.default_rng(0)
        xyz_list, rgb_list, feat_list, idx_list, cut_list = [], [], [], [], []

        for mapping in idxs_radius_patches:
            patch_xyz = room_points[mapping]
            patch_rgb = room_colors[mapping] if room_colors is not None else None
            patch_feat = room_features[mapping] if room_features is not None else None
            n = len(patch_xyz)
            diff = patch_size - n
            if n == 0:
                continue
            if diff > 0:
                ridx = rng.integers(0, n, diff)
                extra = patch_xyz[ridx]
                noise_level = np.linalg.norm(
                    patch_xyz.max(axis=0) - patch_xyz.min(axis=0)
                ) * 1e-2
                extra = extra + rng.normal(0, noise_level, extra.shape)
                xyz_list.append(np.concatenate([patch_xyz, extra]).astype(np.float32))
                if patch_rgb is not None:
                    rgb_list.append(np.concatenate([patch_rgb, patch_rgb[ridx]]))
                if patch_feat is not None:
                    feat_list.append(np.concatenate([patch_feat, patch_feat[ridx]]))
                idx_list.append(np.concatenate([mapping, mapping[ridx]]))
                cut_list.append(n)  # the padded tail is left out of the recomposition
            else:
                fraction = n // patch_size + 1
                for f in range(fraction):
                    with span("rooms.split_fps"):
                        sub = bucket_fps(patch_xyz, patch_size, seed=f)
                    xyz_list.append(patch_xyz[sub].astype(np.float32))
                    if patch_rgb is not None:
                        rgb_list.append(patch_rgb[sub])
                    if patch_feat is not None:
                        feat_list.append(patch_feat[sub])
                    idx_list.append(mapping[sub])
                    cut_list.append(patch_size)

        xyz = np.stack(xyz_list)
        rgb = np.stack(rgb_list).astype(np.float32) if rgb_list else None
        feats = np.stack(feat_list).astype(np.float32) if feat_list else None
        idxs = np.stack(idx_list)
        return xyz, rgb, feats, idxs, np.asarray(cut_list)


def denoise_patch_batch(
    bridge,
    patch_xyz: np.ndarray,
    steps: int,
    patch_rgb: Optional[np.ndarray] = None,
    patch_feat: Optional[np.ndarray] = None,
    use_rgb: bool = False,
    use_feat: bool = False,
    return_steps: bool = False,
    filtering: bool = False,
    cond: Optional[Tuple["RoomConditioning", np.ndarray]] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Normalise (numpy, on the host), sample (on the device of the
    bridge's model) and denormalise a [B, S, 3] patch batch.

    The conditioning is [rgb | feat] of ``patch_rgb`` / ``patch_feat``
    (numpy [B, S, C], as ``use_rgb`` / ``use_feat`` select) or, with
    ``cond`` = (a room's :class:`RoomConditioning`, the batch's [B, S] room
    indices), the rows of the room's channels gathered on the device.

    filtering=True drops the 1% of denoised points of each patch farthest
    from the normalised input patch (``remove_outliers``, on the device)
    before denormalising, and returns (denoised [B, S', 3], keep_mask
    [B, S]) instead of (denoised [B, S, 3], chain [T, B, S, 3] or None)."""
    device = next(bridge.model.parameters()).device
    center = patch_xyz.mean(axis=1, keepdims=True)
    patch = patch_xyz - center
    scale = np.linalg.norm(patch, axis=2, keepdims=True).max(axis=1, keepdims=True)
    patch = (patch / scale).astype(np.float32)

    x_cond = None
    if use_rgb and patch_rgb is not None:
        x_cond = patch_rgb
    if use_feat and patch_feat is not None:
        x_cond = patch_feat if x_cond is None else np.concatenate([x_cond, patch_feat], -1)

    with span("rooms.upload"):
        xb = torch.from_numpy(patch).to(device)
        if cond is not None:
            cb = cond[0].gather(torch.from_numpy(cond[1]).to(device))
        else:
            cb = None if x_cond is None else torch.from_numpy(np.ascontiguousarray(x_cond)).to(device)
    out = bridge.sample(xb, cb, steps=steps, log_count=steps)
    x_pred = out["x_pred"].cpu().numpy()
    if filtering:
        n_out = int(patch.shape[1] * 0.01)
        kept, mask = remove_outliers(x_pred, patch, n_out, device)
        return kept * scale + center, mask

    denoised = x_pred * scale + center
    chain = None
    if return_steps:
        chain = out["x_chain"].cpu().numpy()  # [B, T, S, 3]
        chain = chain * scale[:, None] + center[:, None]
        chain = np.moveaxis(chain, 1, 0)  # [T, B, S, 3]
    return denoised, chain


def gather_patch_batch(mesh, denoised: np.ndarray, chain: Optional[np.ndarray]):
    """Every rank's share of a patch batch, in rank order: the denoised
    patches [b, S, 3] and the chain [T, b, S, 3] or the keep masks [b, S]
    of :func:`denoise_patch_batch`, gathered through the mesh's device."""
    def gather(a: np.ndarray) -> np.ndarray:
        wire = np.ascontiguousarray(a.view(np.uint8) if a.dtype == bool else a)
        out = mesh.all_gather(torch.from_numpy(wire).to(mesh.device)).cpu().numpy()
        return out.view(bool) if a.dtype == bool else out

    denoised = gather(denoised)
    if chain is not None:
        chain = (gather(chain) if chain.dtype == bool
                 else np.moveaxis(gather(np.moveaxis(chain, 1, 0)), 0, 1))
    return denoised, chain


def device_rows(a: np.ndarray, device) -> torch.Tensor:
    """[N, C] ``a`` as a contiguous [N, C] tensor on ``device``, in its own
    dtype, its bytes copied in the order they lie in memory: an F-ordered
    array (ScanNet++'s [C, N] features seen through ``.T``) goes up as its
    C-ordered transpose and is transposed on the device."""
    if a.flags.f_contiguous and not a.flags.c_contiguous:
        return torch.from_numpy(a.T).to(device).T.contiguous()
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class RoomConditioning:
    """A room's conditioning channels (colours, features: [N, C] each, in
    that order) copied to the device once, in their stored dtype.
    ``gather`` gives a batch's [B, S, C] float32 conditioning [rgb | feat]
    from its [B, S] room indices on the device, bit for bit the host's
    ``[rgb[idxs].astype(np.float32) | feat[idxs].astype(np.float32)]``."""

    def __init__(self, device, *channels: np.ndarray):
        with span("rooms.features"):
            self.tables = [device_rows(a, device) for a in channels]

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        flat = rows.reshape(-1)
        parts = [t.index_select(0, flat).float() for t in self.tables]
        cond = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
        return cond.reshape(*rows.shape, -1)


class RunningMean:
    """Overlap-averaged accumulation over the room, in the native runtime
    (the numpy fallback without a compiler)."""

    def __init__(self, room_points: np.ndarray):
        self.sums = np.zeros((len(room_points), 3), dtype=np.float64)
        self.counts = np.zeros(len(room_points), dtype=np.int64)
        self.fallback = np.ascontiguousarray(room_points, np.float32)

    def update(self, patch_batch: np.ndarray, idxs_batch: np.ndarray,
               cut_list: np.ndarray) -> None:
        accumulate_running_mean(self.sums, self.counts, patch_batch, idxs_batch, cut_list)

    def result(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        out, n_miss = finalize_running_mean(self.sums, self.counts, self.fallback)
        if n_miss:
            # never-updated points take random updated predictions
            logger.warning("There are %d points that did not get updated.", n_miss)
            rng = rng or np.random.default_rng(0)
            mask = self.counts == 0
            out[mask] = out[rng.choice(len(out), n_miss)]
        return out


def remove_outliers(gen: np.ndarray, ref: np.ndarray, num_outliers: int, device="cuda"):
    """Drop the ``num_outliers`` points of each cloud of gen farthest from
    ref (their nearest-neighbour distances computed on ``device``, "cuda"
    with no card raises).
    gen, ref [B, N, 3] numpy -> (kept [B, N - num_outliers, 3], keep mask
    [B, N])."""
    device = resolve_device(device)
    d1, _, _, _ = chamfer_distance(torch.as_tensor(gen, device=device),
                                   torch.as_tensor(ref, device=device))
    order = np.argsort(-d1.cpu().numpy(), axis=-1)
    B, N = order.shape
    mask = np.ones((B, N), bool)
    mask[np.arange(B)[:, None], order[:, :num_outliers]] = False
    kept = gen[mask].reshape(B, N - num_outliers, -1)
    return kept, mask


def denoise_room(
    bridge,
    room_points: np.ndarray,
    steps: int = 5,
    k: int = 4,
    patch_size: int = 4096,
    batch_size: int = 32,
    query_radius: float = 0.3,
    room_colors: Optional[np.ndarray] = None,
    room_features: Optional[np.ndarray] = None,
    use_rgb: bool = False,
    use_feat: bool = False,
    average_predictions: bool = True,
    return_steps: bool = False,
    filter_outliers: bool = False,
    seed: int = 42,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """The room pipeline: {"denoised": [N, 3]} (and {"steps": [T, N, 3]}
    with ``return_steps`` and averaging).

    filter_outliers drops 1% of each patch (``remove_outliers``) and leaves
    the filtered points' room indices out of the overlap average; it turns
    ``return_steps`` off, as in the JAX package. Without
    ``average_predictions`` the denoised patches are FPS-sampled back to N
    points. With the bridge on a CUDA device the native host runtime is
    required: its numpy fallback is for CPU hosts.

    ``mesh`` (a ``parallel.mesh.DataMesh``; every rank calls with the same
    room and arguments): every rank builds the same patches, samples its
    ``batch_size / W`` rows of each padded batch on its device, and the
    predictions (and the chain or the keep masks) are gathered in rank
    order, so every rank recomposes the same room as one process would.
    ``batch_size`` must divide over the W ranks."""
    if mesh is not None and batch_size % mesh.world_size:
        raise ValueError(f"batch_size {batch_size} must divide over the "
                         f"{mesh.world_size}-rank mesh")
    device = next(bridge.model.parameters()).device
    if device.type == "cuda" and get_lib() is None:
        raise RuntimeError("the native host runtime did not build (g++): the room path "
                           "on a CUDA device does not run on the numpy fallback")
    if return_steps and filter_outliers:
        # the per-patch filter drops points, so fixed-shape per-step
        # accumulation is impossible
        logger.warning(
            "return_steps is incompatible with filter_outliers; "
            "disabling intermediate-step outputs"
        )
        return_steps = False
    rng = np.random.default_rng(seed)
    n_seeds = int(np.ceil(room_points.shape[0] / patch_size) * k)
    logger.info("Room: %d points, %d seed patches, radius %.2f",
                len(room_points), n_seeds, query_radius)

    with span("rooms.seed"):
        seed_idx = bucket_fps(room_points, n_seeds, seed=seed)
        centers = room_points[seed_idx]
        tree = cKDTree(room_points)
        idxs_radius = tree.query_ball_point(centers, r=query_radius, workers=-1)
        idxs_radius = [np.asarray(i, np.int64) for i in idxs_radius]

    # the patches' coordinates and room indices only: the conditioning is
    # gathered by those indices on the device, batch by batch
    xyz, _, _, idxs, cuts = create_patches(room_points, patch_size, idxs_radius, rng=rng)
    logger.info("Created %d fixed-size patches", len(xyz))
    channels = [a for a, used in ((room_colors, use_rgb), (room_features, use_feat))
                if used and a is not None]

    accum = RunningMean(room_points) if average_predictions else None
    accum_steps = [RunningMean(room_points) for _ in range(steps)] if return_steps else None
    collected = []

    P = len(xyz)
    # pad the LAST batch up to batch_size with repeats: one shape for every
    # batch; the surplus rows are ignored
    with span("rooms.batches"):
        conditioning = RoomConditioning(device, *channels) if channels else None
        for s in range(0, P, batch_size):
            e = min(s + batch_size, P)
            sel = np.arange(s, e)
            pad = batch_size - len(sel)
            if pad > 0:
                sel = np.concatenate([sel, np.full(pad, sel[-1])])
            if mesh is not None:
                sel = shard_batch(sel, mesh)
            d, chain = denoise_patch_batch(
                bridge, xyz[sel], steps, return_steps=return_steps, filtering=filter_outliers,
                cond=None if conditioning is None else (conditioning, idxs[sel]),
            )
            if mesh is not None:
                d, chain = gather_patch_batch(mesh, d, chain)
            valid = e - s
            if filter_outliers:
                # chain holds the keep mask; subset each patch's room indices
                # to the kept points
                keep = chain
                kept_idxs = np.stack([idxs[s + i][keep[i]] for i in range(valid)])
                # the padding duplicates sit at the patch tail and boolean
                # masking keeps order, so the kept real points are the mask's
                # count over the first cut positions
                kept_cuts = np.asarray(
                    [int(keep[i, : cuts[s + i]].sum()) for i in range(valid)]
                )
                if average_predictions:
                    accum.update(d[:valid], kept_idxs, kept_cuts)
                else:
                    collected.append(d[:valid].reshape(-1, 3))
                continue
            if average_predictions:
                accum.update(d[:valid], idxs[s:e], cuts[s:e])
                if return_steps:
                    for t in range(len(chain)):
                        accum_steps[t].update(chain[t][:valid], idxs[s:e], cuts[s:e])
            else:
                collected.append(d[:valid].reshape(-1, 3))

    out: Dict[str, np.ndarray] = {}
    if average_predictions:
        out["denoised"] = accum.result(rng)
        if return_steps:
            out["steps"] = np.stack([a.result(rng) for a in accum_steps])
    else:
        flat = np.concatenate(collected)
        sub = bucket_fps(flat, len(room_points), seed=seed)
        out["denoised"] = flat[sub]
    return out
