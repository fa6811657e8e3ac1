"""Shared set-up of the benchmark's tests: the ``card`` marker, the TINY
configurations and traffic the CPU runs use.

  python -m pytest portbench/tests -q            (the CPU tests)
  python -m pytest portbench/tests -q -m card    (on a machine with a card)
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

TINY_PVD = {"global_embedding_dim": 64, "feat_embed_dim": 8, "attention_heads": 2,
            "channels": [8, 8, 16, 16, 32], "voxel_resolutions": [8, 4, 4, 4],
            "n_sa_blocks": [1, 1, 1, 1], "n_fp_blocks": [1, 1, 1, 1],
            "radius": [0.2, 0.4, 0.8, 1.2], "out_mlp": 16}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny(name: str, extra_features: int = 0) -> dict:
    """The configuration ``name`` at TINY widths, computing in f32, with
    256-point patches (dropout as configured)."""
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["data"]["npoints"] = 256
    cfg["training"].update(amp=False, bs=4)
    cfg["model"].update(time_embed_dim=16, extra_feature_channels=extra_features)
    cfg["model"]["PVD"].update(TINY_PVD)
    return cfg


def tiny_traffic(name: str) -> dict:
    """The traffic mix ``name`` at sizes a CPU test holds."""
    t = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())
    if t["driver"] == "objects":
        t.update(sizes=[600, 900][:len(t["sizes"])], checked_among=len(t["sizes"]),
                 checked_calls=min(t["checked_calls"], 2), traced_calls=2)
    elif t["driver"] == "rooms":
        t.update(points=3000, features=5, batch_size=4, checked_patches=2)
    return t
