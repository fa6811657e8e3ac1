"""On the card: the control comes out not correct and the program correct,
at sizes a test run holds (``portbench.calibrate`` reads them at each
cell's own size for the limits).

  python -m pytest portbench/tests/test_card.py -q -m card
"""

from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT
from portbench import harness

BENCH = harness.load_benchmark(ROOT)


def small(cell: str):
    c = harness.find_cell(BENCH, cell)
    cfg = harness.load_config(ROOT, BENCH, c["config"])
    traffic = harness.load_json(ROOT, "traffic", c["traffic"])
    if traffic["driver"] == "objects":
        traffic.update(sizes=[10_000], clouds_per_call=1, checked_calls=1)
    elif traffic["driver"] == "rooms":
        traffic.update(points=40_000, distinct=1)
    return cfg, traffic, harness.load_json(ROOT, "limits", cell)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_and_the_program_passes(card, cell):
    import importlib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic, limits = small(cell)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}").Driver
    row = driver.calibrate(cfg, traffic, 2 ** 31 + 17, card, None, "fp8", None)
    program = {k: v for k, v in row["program"].items() if k in limits}
    control = {k: v for k, v in row["control"].items() if k in limits}
    assert all(v <= limits[k] for k, v in program.items()), json.dumps(row)
    assert any(v > limits[k] for k, v in control.items()), json.dumps(row)
