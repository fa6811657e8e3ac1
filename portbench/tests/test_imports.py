"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: ``p2p_bridge_tpu_torch`` is not ``p2p_bridge_tpu``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "p2p_bridge_tpu")
PROGRAM = "p2p_bridge_tpu_torch"


def loaded_after(code: str) -> set:
    """Top-level names in sys.modules after running ``code`` in a fresh
    interpreter at the repository's root."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_and_readers_load_no_jax():
    layers = sorted(p.stem for p in (ROOT / "portbench" / "layers").glob("*.py"))
    code = ("import portbench.run, portbench.harness, portbench.calibrate\n"
            "import portbench.drivers.objects, portbench.drivers.rooms\n"
            "from pathlib import Path\nfrom portbench import harness\n"
            f"for m in {layers!r}: harness.load_reader(Path('.'), m)\n"
            "import p2p_bridge_tpu_torch.inference, p2p_bridge_tpu_torch.rooms\n")
    loaded = loaded_after(code)
    assert PROGRAM in loaded
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = ("import portbench.reference.model, portbench.reference.ops, portbench.reference.bridge\n"
            "import portbench.reference.rooms, portbench.reference.plan\n"
            "import portbench.flops, portbench.bounds, portbench.weights, portbench.compare\n")
    loaded = loaded_after(code)
    assert not loaded & (set(FORBIDDEN) | {PROGRAM})


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    """No file of the benchmark names JAX in an import; the reference's
    files name nothing of the program either."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    assert not names & set(FORBIDDEN)
    if "reference" in path.parts:
        assert PROGRAM not in names


def test_the_run_refuses_without_a_card_and_without_the_program(tmp_path):
    """The command exits with another code than 0 and prints no result
    where there is no card, and in a directory of BENCHMARK.json and the
    benchmark's files alone."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                              "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                             cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
