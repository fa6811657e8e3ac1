"""Console and experiment logging (port of p2p_bridge_tpu/utils/logging.py).

``setup_logger`` gives the stdlib logger the reference's console format.
``ExperimentTracker`` writes scalars to ``metrics.jsonl`` and parameter or
gradient histograms to ``histograms.jsonl`` in its output directory; it
also hands them to wandb where that package imports (it is never fetched).
``update_summary`` keeps the benchmark's Summary CSV with the ``csv``
module, in the format the JAX package's pandas version writes, and
``read_summary`` reads it.
"""

from __future__ import annotations

import csv
import json
import logging
import math
import os
import sys
import time
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch


def setup_logger(name: str = "p2pb", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)-8s | %(message)s", "%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger


def _histogram_row(x: torch.Tensor, bins: int) -> torch.Tensor:
    """[min, max, mean, population std, counts of ``bins`` bins] of one
    leaf, on its device: the bins of jnp.histogram (edges as jnp.linspace
    computes them, each bin closed on the left, the last also on the right)
    over [min, max], or [min, min + 1] when every value is equal, as numpy
    widens the range."""
    x = x.detach().reshape(-1).float()
    mn, mx = x.min(), x.max()
    hi = torch.where(mx > mn, mx, mn + 1.0)
    step = torch.arange(bins, device=x.device, dtype=torch.float32) / bins
    edges = torch.cat([mn * (1 - step) + hi * step, hi[None]])
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.bincount(idx, minlength=bins + 2)[1:bins + 1]
    return torch.cat([torch.stack([mn, mx, x.mean(), x.std(correction=0)]), counts.float()])


class ExperimentTracker:
    """Scalar, histogram and image tracker writing ``metrics.jsonl`` and
    ``histograms.jsonl`` under ``output_dir`` (and to wandb when it
    imports and starts)."""

    def __init__(self, output_dir: str, project: str = "", config: Optional[Dict] = None,
                 use_wandb: bool = True):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.jsonl_path = os.path.join(output_dir, "metrics.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                self._wandb.init(project=project or "P2P-Bridge", config=config or {})
            except Exception:  # not installed, or no login: the files suffice
                self._wandb = None

    def log(self, metrics: Dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_histograms(self, tensors: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                       step: int, prefix: str = "param", bins: int = 24) -> None:
        """Per-tensor histograms (the reference's wandb.watch) of a
        module's ``named_parameters()`` or a name -> tensor dict, as one
        line of ``histograms.jsonl``; empty tensors are skipped. The
        statistics are computed on the tensors' device and come to the
        host as one packed [L, 4 + bins] transfer."""
        if isinstance(tensors, torch.nn.Module):
            tensors = dict(tensors.named_parameters())
        leaves = {f"{prefix}/{name}": t for name, t in tensors.items() if t.numel() > 0}
        if not leaves:
            return
        with torch.no_grad():
            packed = torch.stack([_histogram_row(t, bins) for t in leaves.values()]).cpu().numpy()
        recs = {}
        for name, row in zip(leaves, packed):
            mn, mx, mean, std = (float(v) for v in row[:4])
            recs[name] = {"min": mn, "max": mx, "mean": mean, "std": std,
                          "counts": [int(c) for c in row[4:]],
                          "edges": [mn, mx if mx > mn else mn + 1.0]}
        with open(os.path.join(self.output_dir, "histograms.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, "hists": recs}) + "\n")
        if self._wandb is not None:
            try:
                self._wandb.log({k: self._wandb.Histogram(np_histogram=(
                    v["counts"], list(np.linspace(v["edges"][0], v["edges"][1],
                                                  len(v["counts"]) + 1))))
                    for k, v in recs.items()}, step=step)
            except Exception:  # a histogram wandb refuses must not stop training
                pass

    def log_image(self, name: str, path: str, step: int) -> None:
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(path)}, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


def _cell(text: str):
    """A CSV cell as pandas reads it: empty -> NaN, a number -> float."""
    if text == "":
        return math.nan
    try:
        return float(text)
    except ValueError:
        return text


def read_summary(path: str) -> Tuple[str, List[str], Dict[str, Dict]]:
    """A Summary CSV -> (the index column's name, the metric columns,
    {model: {metric: value}}), empty cells as NaN."""
    with open(path, newline="") as f:
        lines = [[c.strip() for c in r] for r in csv.reader(f) if r]
    if not lines:
        return "", [], {}
    columns = lines[0][1:]
    return lines[0][0], columns, {r[0]: dict(zip(columns, map(_cell, r[1:]))) for r in lines[1:]}


def update_summary(path: str, model: str, metrics: Dict[str, float]) -> Dict[str, Dict]:
    """Set ``metrics`` in the row of ``model`` of the Summary CSV at
    ``path`` (rows keyed by model, columns by metric, the index first; a
    new metric is a new column, a new model a new row, an existing cell is
    overwritten and a cell never set stays empty; floats as '%.12f').
    Returns {model: {metric: value}} as written."""
    index_name, columns, rows = read_summary(path) if os.path.exists(path) else ("", [], {})
    for metric, value in metrics.items():
        if metric not in columns:
            columns.append(metric)
        rows.setdefault(model, {})[metric] = value

    def fmt(v) -> str:
        if isinstance(v, str):
            return v
        return "" if v is None or math.isnan(float(v)) else "%.12f" % float(v)

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([index_name] + columns)
        for name, row in rows.items():
            w.writerow([name] + [fmt(row.get(c, math.nan)) for c in columns])
    return rows
