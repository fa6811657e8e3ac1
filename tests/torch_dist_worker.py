"""One rank of the port's data-parallel cases, run on the CPU over gloo.

  python tests/torch_dist_worker.py <rank> <world size> <store file> <case file> <out dir>

tests/test_torch_distributed.py starts W of these and compares what they
write (``<out dir>/rank<r>.npz``) with one process's results, which it
computes in-process with the same functions: ``step_case`` (one
``train_step`` on a fixed global batch), ``room_case`` (``denoise_room``)
and ``train_case`` (two steps of ``train.train``). This module imports
neither jax nor the tests' conftest, so a rank starts in seconds.
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from p2p_bridge_tpu_torch import rooms, train  # noqa: E402
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge  # noqa: E402
from p2p_bridge_tpu_torch.models.unet_pvc import (  # noqa: E402
    build_unet_from_config, init_parameters)
from p2p_bridge_tpu_torch.parallel.mesh import (  # noqa: E402
    initialize_distributed, make_data_mesh, shard_batch)
from p2p_bridge_tpu_torch.parallel.train_step import init_train_state, train_step  # noqa: E402

# TINY (tests/test_torch_parity.py) at twice its widths, no dropout
MODEL = {
    "in_dim": 3, "extra_feature_channels": 0, "out_dim": 3, "time_embed_dim": 16,
    "dropout": 0.0,
    "PVD": {
        "use_global_embedding": True, "global_embedding_dim": 64, "feat_embed_dim": 16,
        "attention_type": "linear", "attention_heads": 2, "attentions": [0, 0, 0, 1],
        "channels": [16, 16, 32, 32, 64], "voxel_resolutions": [8, 4, 4, 4],
        "n_sa_blocks": [1, 1, 1, 1], "n_fp_blocks": [1, 1, 1, 1],
        "radius": [0.2, 0.4, 0.8, 1.2], "out_mlp": 16,
    },
}
DIFFUSION = {"timesteps": 40, "sampling_timesteps": 2, "objective": "pred_noise",
             "beta_start": 1.0e-4, "beta_end": 0.02, "t0": 1.0e-4, "T": 1.0,
             "ot_ode": True, "loss_type": "mse"}
TRAINING = {"optimizer": {"type": "AdamW", "lr": 1e-3, "beta1": 0.9, "beta2": 0.999,
                          "weight_decay": 1e-2}}
FEATS = 12
B, N = 4, 256
ALIGN = {"eps": 0.01, "iters": 100}
# punet: the K7 alignment on, one micro-batch; pvdl: conditioned on FEATS
# channels, the bridge noise drawn (ot_ode off), two micro-batches
STEP_CASES = ("punet", "pvdl")


def step_config(name: str) -> dict:
    """The TINY configuration of a step case, or of the room ("room")."""
    cfg = {"data": {"npoints": N}, "model": copy.deepcopy(MODEL),
           "diffusion": dict(DIFFUSION), "training": copy.deepcopy(TRAINING)}
    # without the global embedding, whose GroupNorm cancels at these widths
    # and turns another order of the sums into gradient noise (see
    # tests/test_torch_model.py GLOBAL_EMBED_TOL; tests/test_torch_train.py
    # holds the step against JAX without it too)
    cfg["model"]["PVD"]["use_global_embedding"] = name == "room"
    if name in ("pvdl", "room"):
        cfg["model"]["extra_feature_channels"] = FEATS
        cfg["model"]["PVD"]["feat_embed_dim"] = 8
        cfg["diffusion"]["ot_ode"] = False
    return cfg


def global_batch(name: str) -> dict:
    """A fixed global batch of B clouds (for punet the clean clouds in
    another order: the alignment has to undo it)."""
    rng = np.random.default_rng(7)
    clean = (rng.normal(size=(B, N, 3)) * 0.5).astype(np.float32)
    noisy = clean + (0.05 * rng.normal(size=clean.shape)).astype(np.float32)
    batch = {"x_gt": clean, "x_start": noisy}
    if name == "punet":
        batch["x_gt"] = clean[:, rng.permutation(N)]
    else:
        batch["x_cond"] = rng.normal(size=(B, N, FEATS)).astype(np.float32)
    return batch


def step_case(name: str, mesh=None) -> dict:
    """One train_step (AdamW, clip 1.0, EMA) of the TINY model from seed 0
    on ``global_batch(name)``, sharded over ``mesh`` when given: the loss,
    the norms, the averaged gradients (before the clip), the parameters,
    Adam's moments and the EMA after it, as numpy."""
    cfg = step_config(name)
    model = build_unet_from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    bridge = P2PBridge.from_config(cfg, model)
    state = init_train_state(model, cfg)
    accum = 1 if name == "punet" else 2
    batch = {k: torch.from_numpy(v) for k, v in global_batch(name).items()}
    if mesh is not None:
        batch = shard_batch(batch, mesh, accum)
    metrics = train_step(bridge, state, batch, torch.Generator().manual_seed(3),
                         grad_clip=1.0, accumulation_steps=accum,
                         align_cfg=ALIGN if name == "punet" else None,
                         return_grads=True, mesh=mesh)
    out = {k: np.asarray(float(metrics[k])) for k in ("loss", "grad_norm", "param_norm")}
    for n, p in model.named_parameters():
        out[f"grad/{n}"] = metrics["grads"][n].numpy()
        out[f"param/{n}"] = p.detach().numpy().copy()
        opt = state.optimizer.state[p]
        out[f"exp_avg/{n}"] = opt["exp_avg"].numpy().copy()
        out[f"exp_avg_sq/{n}"] = opt["exp_avg_sq"].numpy().copy()
        out[f"ema/{n}"] = state.ema.params[n].numpy().copy()
    return out


def room_config() -> dict:
    cfg = step_config("room")
    cfg["data"] = {"npoints": N, "dataset": "ScanNetPP", "point_features": "dino"}
    cfg["diffusion"]["ot_ode"] = True
    return cfg


def synthetic_room(n: int = 1500):
    """A 2 x 2 m floor with a box, noisy, and FEATS feature channels."""
    rng = np.random.default_rng(11)
    floor = np.concatenate([rng.uniform(0, 2, (n - n // 4, 2)), np.zeros((n - n // 4, 1))], 1)
    box = rng.uniform(-0.3, 0.3, (n // 4, 3)) + [1.0, 1.0, 0.3]
    pts = np.concatenate([floor, box]) + rng.normal(size=(n, 3)) * 0.01
    return rng.permutation(pts).astype(np.float32), rng.normal(size=(n, FEATS)).astype(np.float32)


def room_case(mesh=None) -> dict:
    """denoise_room of the synthetic room (batch 4 of 256-point patches,
    2 steps) with the chain, and again with the outlier filter."""
    cfg = room_config()
    model = build_unet_from_config(cfg).eval()
    init_parameters(model, torch.Generator().manual_seed(1))
    with torch.no_grad():  # a step moves a patch a little, as a trained denoiser's does
        model.classifier[2].weight.mul_(0.01)
        model.classifier[2].bias.mul_(0.01)
    bridge = P2PBridge.from_config(cfg, model)
    pts, feats = synthetic_room()
    kw = dict(steps=2, k=2, patch_size=N, batch_size=4, query_radius=0.3,
              room_features=feats, use_feat=True, mesh=mesh)
    with torch.no_grad():
        chained = rooms.denoise_room(bridge, pts, return_steps=True, **kw)
        filtered = rooms.denoise_room(bridge, pts, filter_outliers=True, **kw)
    return {"denoised": chained["denoised"], "steps": chained["steps"],
            "filtered": filtered["denoised"]}


def train_case(case: dict, mesh) -> dict:
    """Two steps of train.train on the configuration in ``case``, counting
    this rank's checkpoint saves."""
    saves = []
    save = train.save_checkpoint
    train.save_checkpoint = lambda *a, **kw: (saves.append(1), save(*a, **kw))
    try:
        state = train.train(case["train_cfg"], "cpu", mesh=mesh)
    finally:
        train.save_checkpoint = save
    return {"train_saves": np.asarray(len(saves)),
            **{f"train_param/{n}": p.detach().numpy().copy()
               for n, p in state.model.named_parameters()}}


def main(argv) -> None:
    rank, world, store, case_file, out_dir = argv
    torch.set_num_threads(1)
    initialize_distributed("gloo", "cpu", init_method=f"file://{store}",
                           world_size=int(world), rank=int(rank))
    mesh = make_data_mesh("cpu")
    case = json.loads(Path(case_file).read_text())
    out = {"jax_loaded": np.asarray("jax" in sys.modules)}
    for name in STEP_CASES:
        out.update({f"{name}/{k}": v for k, v in step_case(name, mesh).items()})
    out.update({f"room/{k}": v for k, v in room_case(mesh).items()})
    out.update(train_case(case, mesh))
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
