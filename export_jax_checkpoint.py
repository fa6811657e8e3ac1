#!/usr/bin/env python
"""Export a training run of the JAX package to one numpy file that the
PyTorch port reads (p2p_bridge_tpu_torch/models/model_loader.py gives the
layout).

  python export_jax_checkpoint.py <run dir | run dir/step_N> --out run.npz

Runs wherever JAX runs (a TPU VM, or the CPU). It reads the run's
``opt.yaml``, builds the restore templates as train.py does (the model's
fresh parameters, then the configured optimizer's ``init``), restores the
latest ``step_N`` (or the one named) with those typed templates, and
writes the step, the parameters, the EMA's parameters where the run kept
them, and Adam's count and moments with the rate schedule's count where
the checkpoint holds optimizer state. ``opt.yaml`` is copied beside the
output. Then, on the machine with the card:

  python -m p2p_bridge_tpu_torch.train --model_path run.npz
  python -m p2p_bridge_tpu_torch.denoise_object --model_path run.npz --data_path x.xyz
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np
import optax

from p2p_bridge_tpu.models import model_loader
from p2p_bridge_tpu.parallel.train_step import make_optimizer

FORMAT_VERSION = 1  # the layout p2p_bridge_tpu_torch/models/model_loader.py reads
logger = logging.getLogger("p2pb")


def flat_arrays(prefix: str, tree) -> Dict[str, np.ndarray]:
    """``{prefix/a/b/c: numpy}`` over the leaves of a param tree; a
    top-level ``{"params": ...}`` collection is left out of the paths."""
    if isinstance(tree, dict) and set(tree) == {"params"}:
        tree = tree["params"]
    return {"/".join([prefix] + [str(k.key) for k in path]): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def adam_and_schedule(opt_state, kind: str) -> Tuple[Any, Optional[Any]]:
    """(Adam's ScaleByAdamState, the ScaleByScheduleState or None) of an
    ``opt_state`` of ``make_optimizer``: optax.adamw's (adam, decay, rate)
    or Adam's chain(add_decayed_weights, adam) of (decay, (adam, rate)).
    Any other layout raises."""
    if kind not in ("AdamW", "Adam"):
        raise ValueError(f"optimizer {kind!r}: the port resumes AdamW and Adam")
    layout = jax.tree_util.tree_structure(opt_state)
    try:
        if kind == "AdamW":
            adam, decay, rate = opt_state
        else:
            decay, (adam, rate) = opt_state
    except (TypeError, ValueError) as e:
        raise ValueError(f"unexpected {kind} state layout: {layout}") from e
    if not (isinstance(adam, optax.ScaleByAdamState) and isinstance(decay, optax.EmptyState)
            and isinstance(rate, (optax.EmptyState, optax.ScaleByScheduleState))):
        raise ValueError(f"unexpected {kind} state layout: {layout}")
    return adam, rate if isinstance(rate, optax.ScaleByScheduleState) else None


def checkpoint_arrays(ckpt: Dict[str, Any], kind: str) -> Dict[str, np.ndarray]:
    """The exported layout of a restored checkpoint {"params", "step"[,
    "ema"][, "opt_state"]} whose optimizer is ``kind``."""
    out = {"format_version": np.asarray(FORMAT_VERSION, np.int32),
           "step": np.asarray(int(ckpt["step"]), np.int32), **flat_arrays("params", ckpt["params"])}
    if ckpt.get("ema") is not None:
        out.update(flat_arrays("ema", ckpt["ema"]))
    if ckpt.get("opt_state") is not None:
        adam, rate = adam_and_schedule(ckpt["opt_state"], kind)
        out["opt/kind"] = np.asarray(kind)
        out["opt/count"] = np.asarray(int(adam.count), np.int32)
        out.update(flat_arrays("opt/mu", adam.mu))
        out.update(flat_arrays("opt/nu", adam.nu))
        if rate is not None:
            out["schedule/count"] = np.asarray(int(rate.count), np.int32)
    return out


def opt_yaml_path(model_path: str) -> str:
    """The opt.yaml that model_loader.load_opt_yaml reads for ``model_path``."""
    base = os.path.abspath(model_path)
    for cand in (base, os.path.dirname(base)):
        path = os.path.join(cand, "opt.yaml")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"opt.yaml not found near {model_path}")


def export(model_path: str, out: str) -> str:
    """Restore the run ``model_path`` (its latest step_N, or the step_N
    named) and write it to ``out``; returns the checkpoint directory read."""
    cfg = model_loader.load_opt_yaml(model_path)
    seed = cfg.training.get("seed", 42)
    _, params, _ = model_loader.load_diffusion(cfg.copy().merge({"model_path": ""}), seed=seed)
    optimizer = make_optimizer(cfg)
    path = model_loader.resolve_model_path(model_path)
    ckpt = model_loader.restore_checkpoint(path, params_template=params,
                                           opt_state_template=optimizer.init(params))
    arrays = checkpoint_arrays(ckpt, cfg.training.optimizer.get("type", "AdamW"))
    out = os.path.abspath(out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, out)
    yaml_in, yaml_out = opt_yaml_path(model_path), os.path.join(os.path.dirname(out), "opt.yaml")
    if not (os.path.exists(yaml_out) and os.path.samefile(yaml_in, yaml_out)):
        shutil.copyfile(yaml_in, yaml_out)
    logger.info("Exported %s (step %d, %d arrays) to %s", path, int(arrays["step"]),
                len(arrays), out)
    return path


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("model_path", help="A run directory (its latest step_N) or a step_N.")
    parser.add_argument("--out", required=True, help="The .npz to write; opt.yaml goes beside it.")
    args = parser.parse_args(argv)
    return export(args.model_path, args.out)


if __name__ == "__main__":
    main()
