"""Each cell's driver through the harness's internal entry at TINY sizes on
the CPU (the command itself refuses to run without a card): a sound run
comes out correct, and a run with the timed path broken underneath comes
out not correct, once for each fault the cell can have: a step that
returns its state unchanged; half of the batch left out; an answer altered
where it is produced. (A cell on one chip has no exchange between chips
to leave out.)"""

from __future__ import annotations

import time

import pytest
import torch

from conftest import ROOT, tiny, tiny_traffic
from portbench import faults, harness

BENCH = harness.load_benchmark(ROOT)
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(cell_name: str, seconds: float = 2.0, seed: int = 2 ** 31 + 11) -> dict:
    cell = harness.find_cell(BENCH, cell_name)
    config = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    cfg = tiny(config["name"], 5 if config["name"] == "PVDL_SNPP" else 0)
    traffic = tiny_traffic(cell["traffic"])
    t0 = time.perf_counter()
    return harness.run_cell(ROOT, BENCH, cell, seed, seconds, False, torch.device("cpu"),
                            lambda: time.perf_counter() - t0, cfg=cfg, traffic=traffic)


SECONDS = {"punet-obj-exact": 2.0, "punet-obj-batch": 2.0, "snpp-room": 4.0}
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_its_line_has_the_contract_keys(cell):
    line = run(cell, SECONDS[cell])
    assert list(line) == KEYS  # ``checks`` last
    assert all(c["value"] <= c["limit"] for c in line["checks"].values()), line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    e2e, _ = harness.cell_metrics(BENCH, cell)
    assert set(line["metrics"]) == {m["name"] for m in e2e} and "setup_s" in line["metrics"]
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == set(harness.load_json(ROOT, "limits", cell))


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault):
    traffic = harness.load_json(ROOT, "traffic", harness.find_cell(BENCH, cell)["traffic"])
    undo = faults.plant(traffic["driver"], fault)
    try:
        line = run(cell, SECONDS[cell])
    finally:
        undo()
    assert not line["correct"], line["checks"]


def test_a_room_whose_host_fps_picks_the_first_points_is_not_correct():
    undo = faults.plant("rooms", faults.SELECTION)
    try:
        line = run("snpp-room", SECONDS["snpp-room"])
    finally:
        undo()
    assert line["checks"]["fps_cover_excess"]["value"] > line["checks"]["fps_cover_excess"]["limit"]
    assert not line["correct"]
