"""The port's experiment logging against the JAX package's: the Summary
CSV (csv module against pandas), the parameter and gradient histograms and
the scalar records, on the CPU."""

import csv
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_bridge_tpu.utils import logging as jax_logging
from p2p_bridge_tpu_torch.utils import logging as port_logging

WRITES = [
    ("PUNet_10000_poisson_0.01_steps5", {"cd_sph(mean)": 0.000634622, "p2f(mean)": 8.80117e-05}),
    ("PUNet_10000_poisson_0.02_steps5", {"cd_sph(mean)": 0.000655978, "p2f(mean)": 1.07079e-04}),
    # a new metric: a new column, empty in the rows before
    ("PUNet_50000_poisson_0.01_steps5", {"cd_sph(mean)": 0.000401802, "emd_sub(mean)": 3.25}),
    # an existing row overwritten, a cell of it left as it was
    ("PUNet_10000_poisson_0.01_steps5", {"p2f(mean)": 1.5e-05, "emd_sub(mean)": 2.0 / 3.0}),
    ("PUNet_10000_poisson_0.03_steps5", {"emd_sub(mean)": 123.456789012345}),
]


def read_cells(path):
    with open(path, newline="") as f:
        return [row for row in csv.reader(f)]


def test_update_summary_writes_the_file_pandas_writes(tmp_path):
    """The same sequence of writes through both versions gives the same
    file, cell by cell (and byte for byte), after every write; the JAX
    package's pandas reader reads the port's file back."""
    import pandas as pd

    port, jax = tmp_path / "port.csv", tmp_path / "jax.csv"
    for model, metrics in WRITES:
        rows = port_logging.update_summary(str(port), model, metrics)
        jax_logging.update_summary(str(jax), model, metrics)
        assert read_cells(port) == read_cells(jax)
        assert port.read_bytes() == jax.read_bytes()
        assert rows[model].keys() >= metrics.keys()
    cells = read_cells(port)
    assert cells[0] == ["", "cd_sph(mean)", "p2f(mean)", "emd_sub(mean)"]
    assert cells[1] == ["PUNet_10000_poisson_0.01_steps5", "0.000634622000", "0.000015000000",
                        "0.666666666667"]
    assert cells[2][3] == "" and cells[4][1:3] == ["", ""]
    df = pd.read_csv(port, index_col=0, sep=r"\s*,\s*", engine="python")
    assert df.loc["PUNet_10000_poisson_0.03_steps5", "emd_sub(mean)"] == pytest.approx(
        123.456789012345, abs=1e-12)
    assert np.isnan(df.loc["PUNet_10000_poisson_0.02_steps5", "emd_sub(mean)"])


def leaves(seed):
    rng = np.random.default_rng(seed)
    return {
        "conv.weight": rng.normal(size=(4, 3, 3)).astype(np.float32),
        "conv.bias": (rng.uniform(-1, 1, size=257) * 1e-3).astype(np.float32),
        "norm.weight": np.ones(16, np.float32),  # every value equal: numpy's widened range
        "empty": np.zeros((0, 4), np.float32),   # skipped
        "scale": np.array([2.5], np.float32),
    }


@pytest.mark.parametrize("prefix", ["param", "grad"])
def test_log_histograms_match_jax(tmp_path, prefix):
    """One line of histograms.jsonl with the JAX version's names, counts,
    edges, min, max, mean and population std (f32), empty leaves left out;
    a module gives its named_parameters."""
    arrays = leaves(3)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port = port_logging.ExperimentTracker(str(port_dir), use_wandb=False)
    want_tracker = jax_logging.ExperimentTracker(str(jax_dir), use_wandb=False)
    port.log_histograms({k: torch.from_numpy(v) for k, v in arrays.items()}, 7, prefix=prefix)
    want_tracker.log_histograms({k: jnp.asarray(v) for k, v in arrays.items()}, 7, prefix=prefix)
    got = json.loads((port_dir / "histograms.jsonl").read_text())
    want = json.loads((jax_dir / "histograms.jsonl").read_text())
    assert got["step"] == want["step"] == 7
    assert set(got["hists"]) == set(want["hists"]) == {
        f"{prefix}/{k}" for k in arrays if k != "empty"}
    for name, w in want["hists"].items():
        g = got["hists"][name]
        assert g["counts"] == w["counts"] and sum(g["counts"]) == arrays[name.split("/")[1]].size
        for key in ("min", "max", "edges"):
            assert g[key] == w[key], (name, key)
        for key in ("mean", "std"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, atol=1e-12, err_msg=name)
    assert got["hists"][f"{prefix}/norm.weight"]["edges"] == [1.0, 2.0]
    assert got["hists"][f"{prefix}/norm.weight"]["counts"][0] == 16

    model = torch.nn.Linear(3, 2)
    port.log_histograms(model, 8)
    line = json.loads((port_dir / "histograms.jsonl").read_text().splitlines()[-1])
    assert set(line["hists"]) == {"param/weight", "param/bias"} and line["step"] == 8


def test_metrics_jsonl_records(tmp_path):
    tracker = port_logging.ExperimentTracker(str(tmp_path), use_wandb=False)
    tracker.log({"loss": torch.tensor(0.25), "netpNorm": np.float32(3.0)}, 10)
    tracker.log({"eval/CD": 1.5}, 20)
    tracker.log_image("eval/pred", str(tmp_path / "x.png"), 20)
    tracker.finish()
    recs = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [10, 20]
    assert recs[0]["loss"] == 0.25 and recs[0]["netpNorm"] == 3.0 and recs[1]["eval/CD"] == 1.5
    assert all(isinstance(r["time"], float) for r in recs)


def test_setup_logger_formats_like_jax():
    logger = port_logging.setup_logger("p2pb_test_port")
    want = jax_logging.setup_logger("p2pb_test_jax")
    assert logger.handlers[0].formatter._fmt == want.handlers[0].formatter._fmt
    assert logger.propagate is False and port_logging.setup_logger("p2pb_test_port") is logger
    assert len(logger.handlers) == 1
