"""Train a P2P-Bridge denoiser with the PyTorch port (port of the root
train.py's loop).

  python -m p2p_bridge_tpu_torch.train --config configs/PVDS_PUNet.yaml \
      --save_dir runs/ [--device cuda|cpu] [--a.b value ...]
  python -m p2p_bridge_tpu_torch.train --config configs/PVDL_SNPP.yaml \
      --save_dir runs/ --data.data_dir <batches> --data.splits_path <splits>

The flags are those of the root train.py (``utils/args.py``) plus
``--device`` (default cuda). The merged configuration is written as
``opt.yaml`` into ``<save_dir>/<name>/`` and the checkpoint, a
``torch.save`` dict that ``denoise_object`` and ``denoise_room`` read, as
``model.pt`` beside it, every ``training.save_interval`` steps and at the
end. Only the CLI reads and writes YAML; :func:`train` takes the
configuration as a dict.

Each step draws a batch from the configured dataset's loader (PUNet's
pooled patches; the ScanNet++ and ARKitScenes batches that
``preprocess_batches`` writes, in exact epochs, with their point features
as ``x_cond``), aligns PUNet's clean patches to the noisy ones by auction
EMD on the device (eps 0.01, 100 rounds; room pairs are aligned offline),
and runs :func:`parallel.train_step.train_step`. Every ``log_interval`` steps it
logs the loss and the parameter and gradient norms (with the pooled
loader's produced / consumed counts) and hands them to the experiment
tracker, which writes ``metrics.jsonl`` into the output directory. Every
``training.watch_interval`` steps the tracker writes the parameters'
histograms to ``histograms.jsonl``, and with ``training.watch_gradients``
the gradients' too, from that step's own backward. Every
``training.viz_interval`` steps :func:`models.evaluation.evaluate` scores
the val loader (with the EMA weights when ``use_ema`` is set) and renders
into ``<output_dir>/output``; an evaluation that fails is logged and
training goes on. With ``profile_dir`` set, steps start+10 to start+14 are
traced with torch.profiler into a Chrome trace in that directory.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .data.batch import get_data_batch
from .data.dataloader import get_dataloader, save_iter
from .models.evaluation import evaluate
from .models.model_loader import restore_checkpoint, save_checkpoint
from .models.p2pb import P2PBridge
from .models.unet_pvc import build_unet_from_config, init_parameters
from .parallel.train_step import init_train_state, train_step
from .utils.args import parse_args, setup_output_subdirs
from .utils.logging import ExperimentTracker

logger = logging.getLogger("p2pb")

Observer = Callable[[int, str, Optional[dict]], None]


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items() if v is not None}


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def train(cfg: dict, device="cuda", observer: Optional[Observer] = None):
    """Run ``cfg["training"]["steps"]`` steps (from the checkpoint's step
    when ``cfg["model_path"]`` names one) and return the TrainState.
    Checkpoints go to ``cfg["output_dir"]``. ``observer(step, event,
    metrics)``, when given, is called with "begin" before each step's batch
    is drawn, "batch" once it is on the device, each phase of the step
    ("align", "forward_backward", "update") as it has been issued, and "end"
    with the step's metrics."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda, but no CUDA device is available")
    training = cfg["training"]
    seed = training.get("seed", 42)
    np.random.seed(seed)
    torch.manual_seed(seed)  # dropout
    generator = torch.Generator(device).manual_seed(seed)  # timesteps, noise
    output_dir = cfg["output_dir"]
    os.makedirs(output_dir, exist_ok=True)
    (outf_syn,) = setup_output_subdirs(output_dir, "output")

    train_loader, val_loader = get_dataloader(cfg)
    model = build_unet_from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(device)
    logger.info("Generated model with %.2f M parameters, computing in %s",
                sum(p.numel() for p in model.parameters()) / 1e6, model.dtype)
    bridge = P2PBridge.from_config(cfg, model)
    use_ema = cfg["model"].get("ema", True)
    state = init_train_state(model, cfg, use_ema=use_ema)
    if cfg.get("model_path"):
        restore_checkpoint(cfg["model_path"], state, restart=cfg.get("restart", False))
        logger.info("Resumed from step %d", state.step)

    align_cfg = {"eps": 0.01, "iters": 100} if cfg["data"]["dataset"] == "PUNet" else None
    clip_cfg = training.get("grad_clip") or {}
    grad_clip = float(clip_cfg["value"]) if clip_cfg.get("enabled", False) else None
    ema_decay = cfg["model"].get("EMA", {}).get("decay", 0.999)
    accum = training.get("accumulation_steps", 1)
    log_interval = training.get("log_interval", 10)
    save_interval = training.get("save_interval", 10000)
    viz_interval = training.get("viz_interval", 10000)
    watch_interval = training.get("watch_interval", 2000)
    watch_gradients = training.get("watch_gradients", False)
    profile_dir = cfg.get("profile_dir")
    tracker = ExperimentTracker(output_dir, project=cfg.get("wandb_project", "P2P-Bridge"),
                                config=cfg, use_wandb=cfg.get("use_wandb", True))

    train_iter = save_iter(train_loader)
    start_step = state.step
    prof = None
    t_last = time.perf_counter()
    try:
        for step in range(start_step, training["steps"]):
            if profile_dir and step == start_step + 10:
                prof = _profiler(device)
                prof.start()
            if prof is not None and step == start_step + 15:
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                trace = os.path.join(profile_dir, f"trace_steps_{step - 5}_{step - 1}.json")
                prof.export_chrome_trace(trace)
                prof = None
                logger.info("Wrote profiler trace to %s", trace)
            if observer:
                observer(step, "begin", None)
            batch = _to_device(get_data_batch(next(train_iter), cfg), device)
            mark = (lambda phase, step=step: observer(step, phase, None)) if observer else None
            if mark:
                mark("batch")
            is_watch_step = bool(watch_interval) and (step + 1) % watch_interval == 0
            metrics = train_step(bridge, state, batch, generator, grad_clip=grad_clip,
                                 accumulation_steps=accum, ema_decay=ema_decay,
                                 align_cfg=align_cfg, mark=mark,
                                 return_grads=is_watch_step and watch_gradients)
            if observer:
                observer(step, "end", metrics)
            if step % log_interval == 0:
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                pool_note = ""
                if hasattr(train_loader, "stats"):
                    st = train_loader.stats()
                    pool_note = "\tpool p/c: %d/%d" % (st["produced"], st["consumed"])
                logger.info("[%6d/%d]\tloss: %10.6f\tnetpNorm: %10.2f\tnetgradNorm: %10.4f"
                            "\t(%.2fs/%d steps)%s", step, training["steps"], loss,
                            float(metrics["param_norm"]), float(metrics["grad_norm"]), dt,
                            log_interval, pool_note)
                tracker.log({"loss": loss, "netpNorm": float(metrics["param_norm"]),
                             "netgradNorm": float(metrics["grad_norm"])}, step)
            if is_watch_step:
                tracker.log_histograms(model, step + 1, prefix="param")
                if "grads" in metrics:
                    tracker.log_histograms(metrics["grads"], step + 1, prefix="grad")
            if (step + 1) % save_interval == 0:
                save_checkpoint(output_dir, state)
                logger.info("Saved checkpoint to %s", output_dir)
            if (step + 1) % viz_interval == 0:
                try:
                    evaluate(bridge, val_loader, cfg, step + 1, out_dir=outf_syn, tracker=tracker,
                             ema_params=state.ema.params if (state.ema is not None
                                                             and cfg.get("use_ema")) else None)
                except Exception as e:  # the evaluation must never stop training
                    logger.warning("Could not evaluate model. Skipping. (%s)", e, exc_info=True)
    finally:
        if prof is not None:
            prof.stop()
        if hasattr(train_loader, "stop"):
            train_loader.stop()

    final = training["steps"]
    if final > start_step and final % save_interval != 0:
        save_checkpoint(output_dir, state)
        logger.info("Saved final checkpoint to %s", output_dir)
    tracker.finish()
    return state


def write_run_config(cfg: dict) -> str:
    """Write the merged configuration as ``opt.yaml`` in
    ``cfg["output_dir"]``, the file ``denoise_object`` and ``denoise_room``
    read beside ``model.pt``; return its path."""
    import yaml  # only the run directory's writer needs YAML

    os.makedirs(cfg["output_dir"], exist_ok=True)
    path = os.path.join(cfg["output_dir"], "opt.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device_parser = argparse.ArgumentParser(add_help=False)
    device_parser.add_argument("--device", type=str, default="cuda",
                               help="torch device, e.g. cuda or cpu.")
    known, rest = device_parser.parse_known_args(argv)
    cfg = parse_args(rest)
    write_run_config(cfg)
    logger.info("Training with config %s on %s", cfg.get("config"), known.device)
    return train(cfg, known.device)


if __name__ == "__main__":
    main()
