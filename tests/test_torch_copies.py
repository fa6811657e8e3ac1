"""The framework-free code the port keeps its own copy of, held against
the JAX package's original: the bridge schedule and sampler plan, the
flax -> torch key map, point-cloud I/O, the object normalisation and the
CLI's YAML reader."""

import ast
import copy
import os
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_model import bf16_tiny, tiny

from p2p_bridge_tpu.data.transforms import normalize_unit_sphere as jax_normalize
from p2p_bridge_tpu.models import schedules as jax_schedules
from p2p_bridge_tpu.models.unet_pvc import build_unet_from_config as jax_build
from p2p_bridge_tpu.utils import config as jax_config
from p2p_bridge_tpu.utils import io as jax_io
from p2p_bridge_tpu.utils import torch_compat
from p2p_bridge_tpu_torch import inference, weights
from p2p_bridge_tpu_torch.config import pvds_punet
from p2p_bridge_tpu_torch.models import schedules
from p2p_bridge_tpu_torch.utils import config as port_config
from p2p_bridge_tpu_torch.utils import io as port_io

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ["PVDS_PUNet", "PVDL_SNPP", "PVDL_ARKIT"]


def assert_same_fields(a, b):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k


@pytest.mark.parametrize("kw", [
    dict(timesteps=1000, beta_start=1e-4, beta_end=0.02, t0=1e-4, T=1.0),
    dict(timesteps=40, beta_start=1e-4, beta_end=0.02, t0=1e-4, T=1.0,
         objective="pred_x0", snr_clip=True),
    dict(timesteps=30, symmetric=False),
])
def test_schedule_and_sampler_plan_equal_the_original(kw):
    port = schedules.BridgeSchedule.create(**kw)
    orig = jax_schedules.BridgeSchedule.create(**kw)
    assert_same_fields(port, orig)
    for steps in (1, 5, 10, kw["timesteps"] - 1):
        assert_same_fields(port.sampler_plan(steps), orig.sampler_plan(steps))
        assert port.sampler_plan(steps).num_steps == steps
    for n, c in ((10, 10), (10, 3), (1000, 1), (5, 0), (7, 2)):
        assert schedules.space_indices(n, c) == jax_schedules.space_indices(n, c)
    with pytest.raises(ValueError):
        schedules.BridgeSchedule.create(timesteps=31)


def flax_tree(cfg, n):
    fmodel = jax_build(jax_config.Config(cfg))
    return jax.eval_shape(lambda: fmodel.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, n, 3)), jnp.zeros((1,)), None, True))


@pytest.mark.parametrize("name", ["PVDS_PUNet", "TINY", "TINY_bf16"])
def test_key_map_equals_the_original(name):
    """Every leaf path of the flax tree maps to the same torch key, with
    the same per-stage conv counts."""
    cfg, n = {"PVDS_PUNet": (pvds_punet(), 2048), "TINY": (tiny(), 256),
              "TINY_bf16": (bf16_tiny(), 256)}[name]
    flat = weights.flatten_params(flax_tree(cfg, n))
    counts = weights._conv_counts(flat)
    keys = [weights._torch_key(path[:-1], counts) for path in flat]
    assert keys == [torch_compat._torch_key(path[:-1], counts) for path in flat]
    assert len(set(zip(keys, (p[-1] for p in flat)))) == len(flat)
    for prefix, rest in (("a", ("vnorm1", "GroupNorm_0")), ("a", ("SE_0", "Dense_1")),
                         ("a", ("point_features", "AdaGN_0", "Dense_0"))):
        assert weights._pvconv_key(prefix, rest) == torch_compat._pvconv_key(prefix, rest)
    assert weights._norm_key("p", ()) == torch_compat._norm_key("p", ())
    assert weights._shared_mlp_key("b", ("AdaGN_2", "Dense_0")) == \
        torch_compat._shared_mlp_key("b", ("AdaGN_2", "Dense_0"))


def cloud(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return {"points": (rng.normal(size=(n, 3)) * 3).astype(np.float32),
            "colors": rng.random((n, 3)).astype(np.float32),
            "normals": rng.normal(size=(n, 3)).astype(np.float32),
            "faces": rng.integers(0, n, size=(20, 3))}


def assert_clouds_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("binary", [True, False])
def test_ply_round_trips_like_the_original(tmp_path, binary):
    c = cloud()
    path = tmp_path / "c.ply"
    jax_io.write_ply(str(path), c["points"], colors=c["colors"], normals=c["normals"],
                     faces=c["faces"], binary=binary)
    got = port_io.read_ply(str(path))
    assert_clouds_equal(got, jax_io.read_ply(str(path)))
    np.testing.assert_allclose(got["points"], c["points"], rtol=1e-6)
    jax_io.write_ply(str(path), c["points"], binary=binary)
    assert_clouds_equal(port_io.load_point_cloud(str(path)),
                        jax_io.load_point_cloud(str(path)))


@pytest.mark.parametrize("ext", [".xyz", ".npy", ".npz"])
def test_point_files_round_trip_like_the_original(tmp_path, ext):
    c = cloud(seed=1)
    path = tmp_path / f"c{ext}"
    if ext == ".xyz":
        port_io.write_xyz(str(path), np.concatenate([c["points"], c["colors"]], 1))
        np.testing.assert_array_equal(port_io.read_xyz(str(path)), jax_io.read_xyz(str(path)))
        other = tmp_path / "d.xyz"
        jax_io.write_xyz(str(other), np.concatenate([c["points"], c["colors"]], 1))
        assert path.read_bytes() == other.read_bytes()
    elif ext == ".npy":
        np.save(path, c["points"].astype(np.float64))
    else:
        np.savez(path, points=c["points"])
    assert_clouds_equal(port_io.load_point_cloud(str(path)),
                        jax_io.load_point_cloud(str(path)))
    with pytest.raises(ValueError):
        port_io.load_point_cloud(str(tmp_path / "c.obj"))


@pytest.mark.parametrize("text", [
    "OFF\n4 2 0\n0 0 0\n1 0 0\n0 1 0\n0 0 1.5\n3 0 1 2\n3 0 2 3\n",
    # counts on the header line, comments, blank lines, a quad keeps its first three
    "OFF 4 2 0\n\n0 0 0\n1 0 0 # a vertex\n0 1 0\n0 0 1.5\n4 0 1 2 3\n3 1 2 3\n",
], ids=["plain", "glued_header"])
def test_read_off_equals_the_original(tmp_path, text):
    path = tmp_path / "m.off"
    path.write_text(text)
    got, want = port_io.read_off(str(path)), jax_io.read_off(str(path))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[0].shape == (4, 3) and got[1].shape == (2, 3)
    path.write_text("PLY\n")
    with pytest.raises(ValueError, match="not an OFF file"):
        port_io.read_off(str(path))


def test_normalize_unit_sphere_equals_the_original():
    p = cloud(seed=2)["points"] + 5.0
    for args in ((), (np.ones((1, 3), np.float32), None), (None, 2.5)):
        for a, b in zip(inference.normalize_unit_sphere(p, *args), jax_normalize(p, *args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_reader_equals_the_original(name):
    path = str(ROOT / "configs" / f"{name}.yaml")
    port = port_config.load_yaml(path)
    orig = jax_config.Config.load(path)
    assert port == orig.to_dict()
    argv = ["--model.PVD.channels", "[1, 2]", "--training.amp=false", "data.npoints=512",
            "--new.key", "x", "stray", "--diffusion.T", "0.5", "--lonely"]
    want_left = jax_config.apply_dot_overrides(orig, list(argv))
    got_left = port_config.apply_dot_overrides(port, list(argv))
    assert got_left == want_left == ["stray", "--lonely"]
    assert port == orig.to_dict()
    assert port["training"]["amp"] is False and port["model"]["PVD"]["channels"] == [1, 2]
    again = copy.deepcopy(port)
    port_config.set_dotted(again, "model.PVD.channels.x", 1)  # a list parent is replaced
    assert again["model"]["PVD"]["channels"] == {"x": 1}


# ---------------------------------------------------------------- training copies
from p2p_bridge_tpu.data import batch as jax_batch  # noqa: E402
from p2p_bridge_tpu.data import dataloader as jax_loader  # noqa: E402
from p2p_bridge_tpu.data import punet as jax_punet  # noqa: E402
from p2p_bridge_tpu.data import transforms as jax_transforms  # noqa: E402
from p2p_bridge_tpu.utils import args as jax_args  # noqa: E402
from p2p_bridge_tpu_torch.data import batch as port_batch  # noqa: E402
from p2p_bridge_tpu_torch.data import dataloader as port_loader  # noqa: E402
from p2p_bridge_tpu_torch.data import punet as port_punet  # noqa: E402
from p2p_bridge_tpu_torch.data import transforms as port_transforms  # noqa: E402
from p2p_bridge_tpu_torch.utils import args as port_args  # noqa: E402


def assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, list):
            assert va == vb, k
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=k)
            assert np.asarray(va).dtype == np.asarray(vb).dtype, k


TRANSFORMS = [
    ("standard", lambda m: m.standard_train_transforms(0.01, 0.02)),
    ("standard_no_rotate", lambda m: m.standard_train_transforms(0.01, 0.03, rotate=False)),
    ("clean", lambda m: m.standard_train_transforms_clean()),
    ("laplacian", lambda m: m.Compose([m.NormalizeUnitSphere(), m.AddLaplacianNoise(0.01, 0.02)])),
    ("uniform_ball", lambda m: m.Compose([m.AddUniformBallNoise(0.05)])),
    ("covariance", lambda m: m.Compose([m.AddCovNoise(np.eye(3) * 1e-4, 2.0)])),
    ("discrete", lambda m: m.Compose([m.AddDiscreteNoise(0.02)])),
]


@pytest.mark.parametrize("name", [n for n, _ in TRANSFORMS])
def test_transforms_equal_the_original(name):
    make = dict(TRANSFORMS)[name]
    pcl = cloud(n=300, seed=3)["points"]
    got = make(port_transforms)({"pcl_clean": pcl.copy()}, np.random.default_rng(4))
    want = make(jax_transforms)({"pcl_clean": pcl.copy()}, np.random.default_rng(4))
    assert_items_equal(got, want)
    for theta in (None, 0.3):
        a = port_transforms.random_rotate_horizontally(pcl, theta, np.random.default_rng(5))
        b = jax_transforms.random_rotate_horizontally(pcl, theta, np.random.default_rng(5))
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


def punet_tree(root, n=700, clouds=2):
    """A tiny PUNet tree: unit-sphere clouds at the three training
    resolutions and the 10k test split."""
    rng = np.random.default_rng(0)
    for split, res in (("train", ("10000", "30000", "50000")), ("test", ("10000",))):
        for r in res:
            d = root / "PUNet" / "pointclouds" / split / f"{r}_poisson"
            d.mkdir(parents=True)
            for i in range(clouds):
                p = rng.normal(size=(n + 50 * i, 3))
                p /= np.linalg.norm(p, axis=1, keepdims=True)
                np.savetxt(d / f"s{i}.xyz", p.astype(np.float32), fmt="%.6f")
    return root


@pytest.mark.parametrize("fast", [True, False], ids=["fast_patches", "full_cloud"])
def test_punet_items_equal_the_original(tmp_path, fast):
    root = punet_tree(tmp_path)
    kw = dict(split="train", patch_size=128, seed=7, fast=fast)
    port = port_punet.get_dataset(str(root), **kw)
    orig = jax_punet.get_dataset(str(root), **kw)
    assert type(port).__name__ == type(orig).__name__ and len(port) == len(orig)
    for idx in (0, 5, 4321):
        assert_items_equal(port[idx], orig[idx])


def loader_cfg(root, loader="epoch"):
    return {"data": {"dataset": "PUNet", "data_dir": str(root), "npoints": 128,
                     "augment": True, "fast_patches": True, "loader": loader, "pool_size": 8},
            "training": {"bs": 2, "seed": 3}, "sampling": {"bs": 2}}


def test_loaders_equal_the_original(tmp_path):
    """NumpyLoader epochs through save_iter, the PooledLoader's first pool
    and draws (taken before its refresh thread starts), the validation
    loader, and the refusal of a dataset neither package has."""
    root = punet_tree(tmp_path)
    port_train, port_val = port_loader.get_dataloader(loader_cfg(root))
    jax_train, jax_val = jax_loader.get_dataloader(jax_config.Config(loader_cfg(root)))
    assert len(port_train) == len(jax_train)
    port_it, jax_it = port_loader.save_iter(port_train), jax_loader.save_iter(jax_train)
    for _ in range(len(port_train) + 2):  # across an epoch boundary
        assert_items_equal(next(port_it), next(jax_it))
    assert_items_equal(next(iter(port_val)), next(iter(jax_val)))

    port_pool, _ = port_loader.get_dataloader(loader_cfg(root, "pool"))
    jax_pool, _ = jax_loader.get_dataloader(jax_config.Config(loader_cfg(root, "pool")))
    for loader in (port_pool, jax_pool):
        loader._fill_initial()
    assert_items_equal(port_pool._pool, jax_pool._pool)
    for _ in range(3):
        np.testing.assert_array_equal(port_pool._rng.choice(8, 2, replace=False),
                                      jax_pool._rng.choice(8, 2, replace=False))
    with pytest.raises(NotImplementedError):  # the room datasets: tests/test_torch_room_data.py
        port_loader.get_dataloader(dict(loader_cfg(root), data={"dataset": "Unknown"}))


@pytest.mark.parametrize("dataset,rgb", [("PUNet", False), ("ScanNetPP", True), ("ScanNetPP", False)])
def test_get_data_batch_equals_the_original(dataset, rgb):
    rng = np.random.default_rng(6)
    batch = {k: rng.normal(size=(2, 16, c)).astype(np.float64)
             for k, c in (("clean_points", 3), ("noisy_points", 3), ("noisy_features", 4),
                          ("noisy_colors", 3))}
    cfg = {"data": {"dataset": dataset, "use_rgb_features": rgb}}
    align = (lambda noisy, clean: clean[:, ::-1])
    for fn in (None, align):
        got = port_batch.get_data_batch(batch, cfg, fn)
        want = jax_batch.get_data_batch(batch, jax_config.Config(cfg), fn)
        assert got.keys() == want.keys()
        for k in got:
            if want[k] is None:
                assert got[k] is None, k
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("argv", [
    ["--config", "CONFIG", "--save_dir", "SAVE"],
    ["--config", "CONFIG", "--save_dir", "SAVE", "--name", "run1", "--training.bs", "4",
     "--data.npoints=512", "--restart", "--use_ema"],
    ["--model_path", "SAVE/PVDS_PUNet/model.pt", "--diffusion.sampling_timesteps", "5"],
], ids=["config", "overrides", "model_path"])
def test_train_args_equal_the_original(tmp_path, argv):
    """The training CLI's parsed configuration, as a dict, equals the JAX
    parser's Config; the model_path form reads the opt.yaml beside it."""
    run = tmp_path / "save" / "PVDS_PUNet"
    run.mkdir(parents=True)
    # an opt.yaml as training saves it: the configuration and its name
    (run / "opt.yaml").write_text((ROOT / "configs" / "PVDS_PUNet.yaml").read_text()
                                  + "name: PVDS_PUNet\n")
    argv = [a.replace("CONFIG", str(ROOT / "configs" / "PVDS_PUNet.yaml"))
            .replace("SAVE", str(tmp_path / "save")) for a in argv]
    got = port_args.parse_args(list(argv))
    want = jax_args.parse_args(list(argv)).to_dict()
    # one flag differs by design: the port's backend is torch.distributed's,
    # chosen from the device when not given (parallel/mesh.default_backend)
    assert want["dist_backend"] == "xla" and got["dist_backend"] is None
    assert got == dict(want, dist_backend=None)
    assert os.path.isdir(got["output_dir"])
    assert port_args.setup_output_subdirs(got["output_dir"], "a", "b") == \
        jax_args.setup_output_subdirs(got["output_dir"], "a", "b")


# ---------------------------------------------------------------- room copies
from p2p_bridge_tpu import runtime as jax_runtime  # noqa: E402
from p2p_bridge_tpu_torch import config as port_configs  # noqa: E402
from p2p_bridge_tpu_torch import runtime as port_runtime  # noqa: E402


def test_native_runtime_source_is_byte_equal():
    port = Path(port_runtime.__file__).parent / "native" / "recompose.cpp"
    orig = Path(jax_runtime.__file__).parent / "native" / "recompose.cpp"
    assert port.read_bytes() == orig.read_bytes()


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("extras", ["none", "float_colors", "uint8_colors", "normals_faces"])
def test_write_ply_is_byte_equal_to_the_original(tmp_path, binary, extras):
    c = cloud(n=40, seed=9)
    kw = {"none": {}, "float_colors": {"colors": c["colors"]},
          "uint8_colors": {"colors": (c["colors"] * 255).astype(np.uint8)},
          "normals_faces": {"colors": c["colors"], "normals": c["normals"],
                            "faces": c["faces"]}}[extras]
    port_io.write_ply(str(tmp_path / "port.ply"), c["points"].astype(np.float64), binary=binary,
                      **kw)
    jax_io.write_ply(str(tmp_path / "jax.ply"), c["points"].astype(np.float64), binary=binary,
                     **kw)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    assert_clouds_equal(port_io.read_ply(str(tmp_path / "port.ply")),
                        jax_io.read_ply(str(tmp_path / "jax.ply")))


@pytest.mark.parametrize("name", ["PVDL_SNPP", "PVDL_ARKIT"])
def test_room_config_dicts_equal_yaml(name):
    """config.PVDL_SNPP / PVDL_ARKIT hold their YAMLs whole, as read by the
    JAX package."""
    want = jax_config.Config.load(str(ROOT / "configs" / f"{name}.yaml")).to_dict()
    assert getattr(port_configs, name) == want
    assert port_configs.pvdl_snpp() == port_configs.PVDL_SNPP
    assert port_configs.pvdl_snpp() is not port_configs.PVDL_SNPP


# ---------------------------------------------------------------- room data copies
# module -> the functions whose code may differ from the original's, and why
ROOM_DATA_COPIES = {
    "scannetpp": set(),
    "arkitscenes": set(),
    "preprocess": set(),
    "rgbd_fusion": set(),
    # the port passes local_files_only: a missing checkpoint raises, nothing is fetched
    "image_features": {"load_dino_extractor"},
}


def code_without_docstrings(path: Path) -> dict:
    """{top-level name: ast dump of its code with every docstring removed}
    of a module, plus its imports under "<imports>"."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    out = {"<imports>": []}
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out["<imports>"].append(ast.dump(node))
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            out[ast.dump(node.targets[0])] = ast.dump(node)
    return out


@pytest.mark.parametrize("name", list(ROOM_DATA_COPIES))
def test_room_data_copy_is_the_original_code(name):
    """Each room-data module of the port is its original's code, name for
    name, docstrings aside, with the listed exceptions; what the code
    computes is held equal to the original's in tests/test_torch_room_data.py
    and tests/test_torch_preprocess.py."""
    port = code_without_docstrings(ROOT / "p2p_bridge_tpu_torch" / "data" / f"{name}.py")
    orig = code_without_docstrings(ROOT / "p2p_bridge_tpu" / "data" / f"{name}.py")
    assert port.keys() == orig.keys()
    differ = {k for k in orig if port[k] != orig[k]}
    assert differ == ROOM_DATA_COPIES[name]
