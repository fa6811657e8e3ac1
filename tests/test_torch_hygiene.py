"""What the PyTorch port may import, and the facts it copies from the JAX
package: the PVDS_PUNet configuration, the plan builder, the width."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from p2p_bridge_tpu.models.pvcnn import build_pvcnn2_plan as jax_plan
from p2p_bridge_tpu_torch.config import PVDL_ARKIT, PVDL_SNPP, PVDS_PUNET
from p2p_bridge_tpu_torch.models.pvcnn import build_pvcnn2_plan as port_plan
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config

ROOT = Path(__file__).resolve().parent.parent
MAIN_PATH = [
    "p2p_bridge_tpu_torch", "p2p_bridge_tpu_torch.kernels", "p2p_bridge_tpu_torch.config",
    "p2p_bridge_tpu_torch.ops", "p2p_bridge_tpu_torch.ops.conv3d_gn",
    "p2p_bridge_tpu_torch.ops.devoxelize", "p2p_bridge_tpu_torch.ops.interpolate",
    "p2p_bridge_tpu_torch.models.modules", "p2p_bridge_tpu_torch.models.pvcnn",
    "p2p_bridge_tpu_torch.models.unet_pvc", "p2p_bridge_tpu_torch.models.schedules",
    "p2p_bridge_tpu_torch.models.p2pb", "p2p_bridge_tpu_torch.weights",
    "p2p_bridge_tpu_torch.inference", "p2p_bridge_tpu_torch.utils.io",
    "p2p_bridge_tpu_torch.utils.config", "p2p_bridge_tpu_torch.denoise_object",
    # training
    "p2p_bridge_tpu_torch.metrics", "p2p_bridge_tpu_torch.metrics.emd_auction",
    "p2p_bridge_tpu_torch.models.loss", "p2p_bridge_tpu_torch.models.model_loader",
    "p2p_bridge_tpu_torch.utils.ema", "p2p_bridge_tpu_torch.utils.args",
    "p2p_bridge_tpu_torch.parallel.train_step", "p2p_bridge_tpu_torch.data.transforms",
    "p2p_bridge_tpu_torch.data.punet", "p2p_bridge_tpu_torch.data.dataloader",
    "p2p_bridge_tpu_torch.data.batch", "p2p_bridge_tpu_torch.train",
    # rooms
    "p2p_bridge_tpu_torch.runtime", "p2p_bridge_tpu_torch.ops.fps", "p2p_bridge_tpu_torch.ops.knn",
    "p2p_bridge_tpu_torch.metrics.chamfer", "p2p_bridge_tpu_torch.metrics.p2m",
    "p2p_bridge_tpu_torch.metrics.metrics", "p2p_bridge_tpu_torch.utils.device",
    "p2p_bridge_tpu_torch.rooms", "p2p_bridge_tpu_torch.denoise_room",
    "p2p_bridge_tpu_torch.evaluate_rooms",
    # object evaluation, the training CLI's tracking
    "p2p_bridge_tpu_torch.metrics.emd_approx", "p2p_bridge_tpu_torch.utils.logging",
    "p2p_bridge_tpu_torch.utils.visualize", "p2p_bridge_tpu_torch.models.evaluation",
    "p2p_bridge_tpu_torch.evaluate_objects",
    # room training and the offline data tools
    "p2p_bridge_tpu_torch.data.scannetpp", "p2p_bridge_tpu_torch.data.arkitscenes",
    "p2p_bridge_tpu_torch.data.preprocess", "p2p_bridge_tpu_torch.data.rgbd_fusion",
    "p2p_bridge_tpu_torch.data.image_features", "p2p_bridge_tpu_torch.preprocess_batches",
    "p2p_bridge_tpu_torch.extract_image_features",
    # full attention, the bench and data parallelism
    "p2p_bridge_tpu_torch.parallel.mesh", "p2p_bridge_tpu_torch.utils.flops",
    "p2p_bridge_tpu_torch.bench", "chip_smoke",
]
PORT_SOURCES = sorted((ROOT / "p2p_bridge_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_denoise.py", ROOT / "profile_scatter.py"]


def clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "P2PB_PLATFORM"}
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def main_path_modules():
    """sys.modules after MAIN_PATH is imported in a fresh interpreter."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {MAIN_PATH!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_main_path_imports_no_jax_flax_or_yaml(main_path_modules):
    banned = ("jax", "flax", "orbax", "optax", "yaml")
    assert [m for m in main_path_modules if m.split(".")[0] in banned] == []


def test_main_path_imports_no_pandas(main_path_modules):
    """The card's machine has no pandas: evaluate_rooms writes its CSV with
    the csv module."""
    assert [m for m in main_path_modules if m.split(".")[0] == "pandas"] == []


def test_port_sources_never_import_pandas():
    for path in PORT_SOURCES:
        for module in imported_modules(path):
            assert module.split(".")[0] != "pandas", f"{path}: {module}"


def test_main_path_loads_nothing_of_the_jax_package(main_path_modules):
    assert [m for m in main_path_modules if is_jax_package(m)] == []


def is_jax_package(module: str) -> bool:
    return module == "p2p_bridge_tpu" or module.startswith("p2p_bridge_tpu.")


def imported_modules(path: Path):
    """Every module an import statement of ``path`` names (absolute
    imports; a relative import stays inside its own package)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{alias.name}" for alias in node.names)


def test_port_sources_never_import_jax():
    for path in PORT_SOURCES:
        for module in imported_modules(path):
            assert module.split(".")[0] not in ("jax", "flax", "orbax", "optax"), \
                f"{path}: {module}"


def test_the_exporter_imports_nothing_of_the_port():
    """export_jax_checkpoint.py runs where JAX runs: it reads the JAX
    package and writes numpy, with nothing of p2p_bridge_tpu_torch."""
    modules = list(imported_modules(ROOT / "export_jax_checkpoint.py"))
    assert any(is_jax_package(m) for m in modules)
    assert [m for m in modules if m.split(".")[0] == "p2p_bridge_tpu_torch"] == []


def test_port_sources_never_import_the_jax_package():
    """No import of p2p_bridge_tpu or a submodule anywhere in the port or
    chip_smoke.py, at any depth of a function."""
    assert imported_modules(ROOT / "tests" / "test_torch_ops.py")  # the scan sees imports
    assert any(is_jax_package(m) for m in imported_modules(ROOT / "tests" / "test_torch_ops.py"))
    for path in PORT_SOURCES:
        bad = [m for m in imported_modules(path) if is_jax_package(m)]
        assert bad == [], f"{path}: {bad}"


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=clean_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_pvds_punet_dict_equals_yaml():
    """Every section, the data loader's and the training's included
    (optimizer, scheduler, clip, batch size, steps, intervals, seed, EMA)."""
    with open(ROOT / "configs" / "PVDS_PUNet.yaml") as f:
        cfg = yaml.safe_load(f)
    for section in ("data", "diffusion", "model", "training", "sampling"):
        assert PVDS_PUNET[section] == cfg[section], section
    assert PVDS_PUNET == cfg
    assert PVDS_PUNET["training"]["amp"] is True
    assert PVDS_PUNET["training"]["optimizer"]["type"] == "AdamW"
    assert PVDS_PUNET["model"]["ema"] is True and PVDS_PUNET["data"]["pool_size"] == 2048


@pytest.mark.parametrize("name", ["PVDS_PUNet", "PVDL_SNPP", "PVDL_ARKIT"])
def test_plan_builder_copy_equals_original(name):
    with open(ROOT / "configs" / f"{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    pvd, model = cfg["model"]["PVD"], cfg["model"]
    extra = pvd.get("extra_feature_channels", model.get("extra_feature_channels", 0))
    kw = dict(
        npoints=cfg["data"]["npoints"], channels=pvd["channels"],
        n_sa_blocks=pvd["n_sa_blocks"], n_fp_blocks=pvd["n_fp_blocks"],
        radius=pvd["radius"], voxel_resolutions=pvd["voxel_resolutions"],
        input_dim=model.get("in_dim", 3),
        extra_feature_channels=pvd.get("feat_embed_dim", extra),
        embed_dim=model.get("time_embed_dim", 64), attentions=pvd["attentions"],
        out_mlp=pvd.get("out_mlp", 128), centers=pvd.get("centers"))
    assert dataclasses.asdict(port_plan(**kw)) == dataclasses.asdict(jax_plan(**kw))


def test_full_width_parameter_count():
    with torch.device("meta"):
        model = build_unet_from_config(PVDS_PUNET)
    assert sum(p.numel() for p in model.parameters()) == 26_441_155


@pytest.mark.parametrize("name", ["PVDL_SNPP", "PVDL_ARKIT"])
def test_room_model_parameter_count(name):
    """The conditioned room model as shipped: 118,666,115 parameters,
    computing in bf16 (training.amp)."""
    cfg = {"PVDL_SNPP": PVDL_SNPP, "PVDL_ARKIT": PVDL_ARKIT}[name]
    with torch.device("meta"):
        model = build_unet_from_config(cfg)
    assert sum(p.numel() for p in model.parameters()) == 118_666_115
    assert model.dtype == torch.bfloat16 and model.extra_feature_channels == 384
