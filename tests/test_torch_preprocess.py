"""The port's offline data tools against the JAX package's, on the CPU:
the paired-batch preprocessing (data/preprocess.py and the
preprocess_batches CLI), RGB-D fusion (data/rgbd_fusion.py) and the image
feature lifting (data/image_features.py and the extract_image_features
CLI). Every output is np.array_equal to the original's."""

import importlib.util
import os
import sys
from pathlib import Path

os.environ.setdefault("HF_HUB_OFFLINE", "1")  # no test here may reach a model hub
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from p2p_bridge_tpu.data import image_features as jax_feat  # noqa: E402
from p2p_bridge_tpu.data import preprocess as jax_pre  # noqa: E402
from p2p_bridge_tpu.data import rgbd_fusion as jax_fusion  # noqa: E402
from p2p_bridge_tpu_torch import extract_image_features as feat_cli  # noqa: E402
from p2p_bridge_tpu_torch import preprocess_batches as pre_cli  # noqa: E402
from p2p_bridge_tpu_torch.data import image_features as port_feat  # noqa: E402
from p2p_bridge_tpu_torch.data import preprocess as port_pre  # noqa: E402
from p2p_bridge_tpu_torch.data import rgbd_fusion as port_fusion  # noqa: E402
from p2p_bridge_tpu_torch.utils.io import write_ply  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NPOINTS, RADIUS, FEATS = 256, 0.4, 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The dino test's tiny model: torch's CPU threads cost more than they
    give beside the other test processes."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_same(got, want):
    """Equal values and dtypes, through tuples, lists and dicts."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


# ---------------------------------------------------------------- preprocessing
def test_optimize_assignments_equals_the_original():
    """The greedy unique assignment on real candidates, and its fallback to
    the nearest when every candidate is taken."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(300, 3)).astype(np.float32)
    b = rng.normal(size=(280, 3)).astype(np.float32)  # fewer than a: some fall back
    for k in (1, 4, 32):
        cn = port_pre.find_closest_neighbors(a, b, k=k)
        assert_same(cn, jax_pre.find_closest_neighbors(a, b, k=k))
        got = port_pre.optimize_assignments(a, b, cn)
        assert_same(got, jax_pre.optimize_assignments(a, b, cn))
        fell_back = len(got) - len(np.unique(got))
        assert fell_back >= len(a) - len(b)  # more points than candidates: fallbacks
    cn = np.array([[0, 1], [0, 1], [0, 1]])
    assert port_pre.optimize_assignments(np.zeros((3, 3)), np.zeros((2, 3)), cn).tolist() == [0, 1, 0]
    # k above the candidates: every point of b, in distance order
    assert_same(port_pre.find_closest_neighbors(a[:5], b[:3], k=8),
                jax_pre.find_closest_neighbors(a[:5], b[:3], k=8))


@pytest.mark.parametrize("colors", [False, True])
def test_sample_mesh_uniform_equals_the_original(colors):
    verts, faces = scene_mesh(np.random.default_rng(1))
    vc = np.random.default_rng(2).uniform(size=verts.shape).astype(np.float32) if colors else None
    for seed in (0, 5):
        got = port_pre.sample_mesh_uniform(verts, faces, 2000, vert_colors=vc, seed=seed)
        assert_same(got, jax_pre.sample_mesh_uniform(verts, faces, 2000, vert_colors=vc, seed=seed))
    assert (got[1] is None) == (not colors)


def grid(nu, nv, point):
    u, v = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv), indexing="ij")
    verts = np.stack(point(u, v), -1).reshape(-1, 3)
    a = (np.arange(nu - 1)[:, None] * nv + np.arange(nv - 1)[None, :]).ravel()
    return verts, np.concatenate([np.stack([a, a + 1, a + nv], 1),
                                  np.stack([a + 1, a + nv + 1, a + nv], 1)])


def scene_mesh(rng):
    """A 2 x 2 m floor with a box of side 2s standing on it."""
    parts = [grid(11, 11, lambda u, v: (2 * u, 2 * v, 0 * u))]
    cx, cy, s = *rng.uniform(0.7, 1.3, 2), 0.3
    for face in (lambda u, v: (cx + s * (2 * u - 1), cy + s * (2 * v - 1), 0 * u + 2 * s),
                 lambda u, v: (0 * u + cx - s, cy + s * (2 * u - 1), 2 * s * v),
                 lambda u, v: (0 * u + cx + s, cy + s * (2 * u - 1), 2 * s * v),
                 lambda u, v: (cx + s * (2 * u - 1), 0 * u + cy - s, 2 * s * v),
                 lambda u, v: (cx + s * (2 * u - 1), 0 * u + cy + s, 2 * s * v)):
        parts.append(grid(5, 5, face))
    verts, faces, off = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    return np.concatenate(verts).astype(np.float32), np.concatenate(faces)


def write_scene(scene: Path, seed: int, n: int = 3000, feats=True, colors=True):
    """A ScanNet++ scene: scans/mesh_aligned_0.05.ply (the mesh),
    scans/iphone.ply (n noisy points from it, with colours) and
    features/dino_iphone.npy ([FEATS, n], seeded)."""
    rng = np.random.default_rng(seed)
    verts, faces = scene_mesh(rng)
    (scene / "scans").mkdir(parents=True)
    write_ply(str(scene / "scans" / "mesh_aligned_0.05.ply"), verts, faces=faces)
    noisy, _ = jax_pre.sample_mesh_uniform(verts, faces, n, seed=seed + 100)
    noisy = (noisy + rng.normal(size=noisy.shape) * 0.01).astype(np.float32)
    write_ply(str(scene / "scans" / "iphone.ply"), noisy,
              colors=rng.uniform(size=(n, 3)).astype(np.float32) if colors else None)
    if feats:
        (scene / "features").mkdir()
        np.save(scene / "features" / "dino_iphone.npy",
                rng.normal(size=(FEATS, n)).astype(np.float32))


def read_tree(root: Path) -> dict:
    return {str(p.relative_to(root)): dict(np.load(p)) for p in sorted(root.rglob("*.npz"))}


@pytest.mark.parametrize("feature_type", ["dino", None])
def test_preprocess_scene_writes_the_original_files(tmp_path, feature_type):
    """preprocess_scene at npoints 256, r 0.4: the same batch files, every
    key np.array_equal, with batches both padded (fewer than 256 scan
    points in the sphere) and cut by the host FPS (more)."""
    write_scene(tmp_path / "scene", seed=3)
    kw = dict(npoints=NPOINTS, radius=RADIUS, feature_type=feature_type, seed=4)
    n_port = port_pre.preprocess_scene(str(tmp_path / "scene"), str(tmp_path / "port"), **kw)
    n_jax = jax_pre.preprocess_scene(str(tmp_path / "scene"), str(tmp_path / "jax"), **kw)
    assert n_port == n_jax > 0
    port, orig = read_tree(tmp_path / "port"), read_tree(tmp_path / "jax")
    assert_same(port, orig)
    padded = sum(len(np.unique(b["idxs"])) < NPOINTS for b in port.values())
    assert 0 < padded < len(port)  # some padded, some through the host FPS
    for b in port.values():
        assert b["noisy"].shape == b["clean"].shape == (NPOINTS, 6)
        assert ("features" in b) == (feature_type is not None)
        if feature_type:
            assert b["features"].shape == (NPOINTS, FEATS) and b["features"].dtype == np.float16


def test_preprocess_scene_skips_like_the_original(tmp_path):
    """Missing scans, missing features, a feature count that does not match
    the scan: nothing written, 0 batches, on both sides."""
    write_scene(tmp_path / "nofeat", seed=5, n=500, feats=False)
    write_scene(tmp_path / "short", seed=6, n=500)
    np.save(tmp_path / "short" / "features" / "dino_iphone.npy", np.zeros((FEATS, 499)))
    (tmp_path / "empty").mkdir()
    for scene in ("nofeat", "short", "empty"):
        for module in (port_pre, jax_pre):
            out = tmp_path / "out" / module.__name__ / scene
            assert module.preprocess_scene(str(tmp_path / scene), str(out), npoints=64,
                                           feature_type="dino") == 0
            assert not out.exists()


def test_preprocess_batches_cli_writes_what_preprocess_scene_writes(tmp_path):
    """python -m p2p_bridge_tpu_torch.preprocess_batches with two spawned
    workers over three scenes (one without colours) writes, per scene, the
    files preprocess_scene writes."""
    for i, scene in enumerate(("s0", "s1", "s2")):
        write_scene(tmp_path / "data" / scene, seed=10 + i, n=1500, colors=i != 2)
    (tmp_path / "data" / "not_a_scene.txt").write_text("")
    pre_cli.main(["--data_root", str(tmp_path / "data"), "--output_root", str(tmp_path / "cli"),
                  "--npoints", str(NPOINTS), "--r", str(RADIUS), "--feature_type", "dino",
                  "--workers", "2", "--seed", "9"])
    for scene in ("s0", "s1", "s2"):
        n = port_pre.preprocess_scene(str(tmp_path / "data" / scene),
                                      str(tmp_path / "direct" / scene), npoints=NPOINTS,
                                      radius=RADIUS, feature_type="dino", seed=9)
        assert n > 0
    assert_same(read_tree(tmp_path / "cli"), read_tree(tmp_path / "direct"))


# ---------------------------------------------------------------- RGB-D fusion
def rgbd_frame(rng, h=24, w=32, integer_depth=True, rgb_scale=2):
    depth = rng.uniform(0.5, 4.0, (h, w))
    depth[rng.uniform(size=(h, w)) < 0.1] = 0  # holes
    depth[0, :3] = 12.0  # beyond depth_trunc
    pose = np.eye(4)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    return {"depth": (depth * 1000).astype(np.uint16) if integer_depth else depth.astype(np.float32),
            "intrinsics": np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]]),
            "cam_to_world": pose,
            "rgb": rng.integers(0, 256, (h * rgb_scale, w * rgb_scale, 3)).astype(np.uint8)}


@pytest.mark.parametrize("integer_depth", [True, False], ids=["uint16_mm", "float_m"])
@pytest.mark.parametrize("stride", [1, 3])
def test_backproject_depth_equals_the_original(integer_depth, stride):
    f = rgbd_frame(np.random.default_rng(6), integer_depth=integer_depth)
    for rgb in (f["rgb"], None, f["rgb"][::2, ::2].astype(np.float32) / 255.0):
        args = (f["depth"], f["intrinsics"], f["cam_to_world"], rgb)
        got = port_fusion.backproject_depth(*args, stride=stride, depth_trunc=10.0)
        assert_same(got, jax_fusion.backproject_depth(*args, stride=stride, depth_trunc=10.0))
    assert len(got[0]) > 0


def test_voxel_downsample_and_fuse_rgbd_frames_equal_the_original():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    cols = rng.uniform(size=(500, 3)).astype(np.float32)
    for c in (cols, None):
        assert_same(port_fusion.voxel_downsample(pts, 0.2, c),
                    jax_fusion.voxel_downsample(pts, 0.2, c))
    frames = [rgbd_frame(rng), rgbd_frame(rng, integer_depth=False)]
    for fs in (frames, [frames[0], {k: v for k, v in frames[1].items() if k != "rgb"}]):
        for stride in (1, 2):
            got = port_fusion.fuse_rgbd_frames(fs, voxel_size=0.05, stride=stride)
            assert_same(got, jax_fusion.fuse_rgbd_frames(fs, voxel_size=0.05, stride=stride))
    assert "colors" not in got  # one frame without rgb: no colours at all


# ---------------------------------------------------------------- image features
def camera_frames(rng, points, n_frames=2, h=56, w=84, with_depth=True):
    """Frames looking at ``points`` from around them: a seeded image, K, the
    world-to-camera pose and, where ``with_depth``, a depth map rendered
    from the points with a hole."""
    frames = []
    center = points.mean(0)
    for i in range(n_frames):
        eye = center + np.array([np.cos(i), np.sin(i), 0.3]) * 3.0
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        rot = np.stack([right, down, fwd])
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = rot, -rot @ eye
        K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
        frame = {"image": rng.integers(0, 256, (h, w, 3)).astype(np.uint8), "intrinsics": K,
                 "world_to_cam": w2c}
        if with_depth:
            uv, z = port_feat.project_points(points, K, w2c)
            depth = np.zeros((h, w))
            ok = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h) & (z > 0)
            u, v = uv[ok, 0].astype(int), uv[ok, 1].astype(int)
            order = np.argsort(-z[ok])  # nearest written last
            depth[v[order], u[order]] = z[ok][order]
            depth[: h // 3] = 0  # a hole: no measurement
            frame["depth"] = depth.astype(np.float32)
        frames.append(frame)
    return frames


def scene_points(rng, n=400):
    pts = rng.uniform(-1, 1, (n, 3))
    pts[: n // 2, 2] = -1.0  # a floor that the box above hides in part
    return pts.astype(np.float32)


@pytest.mark.parametrize("feat_dim,patch", [(384, 14), (16, 8)])
def test_descriptor_extractor_equals_the_original(feat_dim, patch):
    img = np.random.default_rng(8).integers(0, 256, (61, 90, 3)).astype(np.uint8)
    got = port_feat.load_descriptor_extractor(feat_dim, patch, seed=2)(img)
    assert_same(got, jax_feat.load_descriptor_extractor(feat_dim, patch, seed=2)(img))
    assert got.shape == (61 // patch, 90 // patch, feat_dim)


@pytest.mark.parametrize("with_depth", [True, False], ids=["depth_map", "zbuffer"])
def test_projection_occlusion_and_lifting_equal_the_original(with_depth):
    rng = np.random.default_rng(9)
    pts = scene_points(rng)
    frames = camera_frames(rng, pts, with_depth=with_depth)
    feats = rng.normal(size=(7, 11, 5)).astype(np.float32)
    accs = [port_feat.FeatureAccumulator(len(pts), 5), jax_feat.FeatureAccumulator(len(pts), 5)]
    for f in frames:
        H, W = f["image"].shape[:2]
        uv, z = port_feat.project_points(pts, f["intrinsics"], f["world_to_cam"])
        assert_same((uv, z), jax_feat.project_points(pts, f["intrinsics"], f["world_to_cam"]))
        for kw in ({}, {"zbuf_downscale": 4, "depth_tol": 0.01}):
            vis = port_feat.visible_mask_with_occlusion(uv, z, W, H, frame_depth=f.get("depth"),
                                                        **kw)
            assert_same(vis, jax_feat.visible_mask_with_occlusion(
                uv, z, W, H, frame_depth=f.get("depth"), **kw))
        inside = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H) & (z > 0)
        assert 0 < vis.sum() < inside.sum()  # some points occluded or unmeasured
        n = [module.lift_frame_features(pts, feats, f["intrinsics"], f["world_to_cam"], (W, H),
                                        acc, frame_depth=f.get("depth"))
             for module, acc in zip((port_feat, jax_feat), accs)]
        assert n[0] == n[1] > 0
    assert_same(accs[0].result(), accs[1].result())
    out, observed = accs[0].result()
    assert 0 < observed.sum() < len(pts)
    for k in (1, 3):
        assert_same(port_feat.interpolate_missing_features(pts, out, observed, k=k),
                    jax_feat.interpolate_missing_features(pts, out, observed, k=k))
    for observed in (np.ones(len(pts), bool), np.zeros(len(pts), bool)):
        assert port_feat.interpolate_missing_features(pts, out, observed) is out


@pytest.mark.parametrize("with_depth", [True, False], ids=["depth_map", "zbuffer"])
def test_process_scene_equals_the_original(with_depth):
    rng = np.random.default_rng(10)
    pts = scene_points(rng, 300)
    frames = camera_frames(rng, pts, 3, with_depth=with_depth)
    for extractor in (None, port_feat.load_descriptor_extractor(12, 7)):
        got = port_feat.process_scene(pts, frames, extractor, feat_dim=24)
        want = jax_feat.process_scene(pts, frames, None if extractor is None else
                                      jax_feat.load_descriptor_extractor(12, 7), feat_dim=24)
        assert_same(got, want)
        assert got.shape == (300, 24 if extractor is None else 12) and np.isfinite(got).all()
    with pytest.raises(ValueError, match="no frames"):
        port_feat.process_scene(pts, [])


def root_cli_module():
    spec = importlib.util.spec_from_file_location("root_extract_image_features",
                                                  ROOT / "extract_image_features.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def frame_scenes(tmp_path: Path, layout: str, npoints: int = 250) -> None:
    """The same scene0 (scan + two-frame frames.npz: shared [3, 3]
    intrinsics and a depth stack, or per-frame intrinsics and no depth)
    and a scene without frames under tmp_path/port and tmp_path/orig."""
    rng = np.random.default_rng(11)
    pts = scene_points(rng, npoints)
    frames = camera_frames(rng, pts, 2, with_depth=layout == "depth_shared_K")
    arrays = {"images": np.stack([f["image"] for f in frames]),
              "world_to_cam": np.stack([f["world_to_cam"] for f in frames])}
    if layout == "depth_shared_K":
        arrays["intrinsics"] = frames[0]["intrinsics"]
        arrays["depth"] = np.stack([f["depth"] for f in frames])
    else:
        arrays["intrinsics"] = np.stack([f["intrinsics"] for f in frames])
    for root in ("port", "orig"):
        scene = tmp_path / root / "scene0"
        (scene / "scans").mkdir(parents=True)
        write_ply(str(scene / "scans" / "iphone.ply"), pts)
        np.savez(scene / "frames.npz", **arrays)
        (tmp_path / root / "no_frames" / "scans").mkdir(parents=True)


def run_both_clis(tmp_path: Path, monkeypatch, argv: list, port_argv: list = ()) -> tuple:
    """The port's CLI (with ``port_argv`` added) over tmp_path/port and the
    root CLI over tmp_path/orig: the two scene0 features files."""
    feat_cli.main(["--data_root", str(tmp_path / "port"), *argv, *port_argv])
    monkeypatch.setattr(sys, "argv", ["extract_image_features.py", "--data_root",
                                      str(tmp_path / "orig"), *argv])
    root_cli_module().main()
    out = Path("scene0") / "features" / f"{argv[argv.index('--feature_name') + 1]}_iphone.npy"
    return np.load(tmp_path / "port" / out), np.load(tmp_path / "orig" / out)


@pytest.mark.parametrize("layout", ["depth_shared_K", "no_depth"])
def test_extract_image_features_cli_writes_the_root_clis_file(tmp_path, monkeypatch, layout):
    """A scene with a two-frame frames.npz: the port's CLI and the root CLI
    write the same [C, N] float16 features file; a scene without frames is
    skipped, and an existing file is kept."""
    frame_scenes(tmp_path, layout)
    argv = ["--feat_dim", "32", "--feature_name", "desc"]
    got, want = run_both_clis(tmp_path, monkeypatch, argv)
    out = Path("scene0") / "features" / "desc_iphone.npy"
    assert_same(got, want)
    assert got.shape == (32, 250) and got.dtype == np.float16
    assert not (tmp_path / "port" / "no_frames" / "features").exists()
    written = os.stat(tmp_path / "port" / out).st_mtime_ns
    feat_cli.main(["--data_root", str(tmp_path / "port"), *argv])
    assert os.stat(tmp_path / "port" / out).st_mtime_ns == written


@pytest.fixture
def no_network(monkeypatch):
    """Any attempt to open a connection or resolve a host fails the test
    before it leaves the process."""
    import socket

    def refuse(*args, **kwargs):
        raise AssertionError(f"network access attempted: {args[:2]}")

    for owner, name in ((socket, "getaddrinfo"), (socket, "create_connection"),
                        (socket.socket, "connect"), (socket.socket, "connect_ex")):
        monkeypatch.setattr(owner, name, refuse)


def tiny_dino_checkpoint(path: Path) -> str:
    """A 2-layer Dinov2 model and its image processor, saved locally."""
    import torch
    from transformers import BitImageProcessor, Dinov2Config, Dinov2Model

    cfg = Dinov2Config(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                       patch_size=14, image_size=70, num_channels=3)
    torch.manual_seed(0)
    Dinov2Model(cfg).save_pretrained(str(path))
    BitImageProcessor(do_resize=True, size={"shortest_edge": 70}, do_center_crop=True,
                      crop_size={"height": 70, "width": 70}, do_rescale=True,
                      do_normalize=True, image_mean=[0.485, 0.456, 0.406],
                      image_std=[0.229, 0.224, 0.225]).save_pretrained(str(path))
    return str(path)


def test_dino_extractor_reads_a_local_checkpoint_as_the_original(tmp_path, no_network):
    pytest.importorskip("transformers")
    ckpt = tiny_dino_checkpoint(tmp_path / "tiny-dinov2")
    img = np.random.default_rng(12).integers(0, 255, (80, 120, 3)).astype(np.uint8)
    got = port_feat.load_dino_extractor(ckpt)(img)
    assert_same(got, jax_feat.load_dino_extractor(ckpt)(img))
    assert got.shape == (5, 5, 32)


def test_dino_extractor_raises_without_a_local_checkpoint(tmp_path, no_network):
    """An empty directory: both raise (and nothing is fetched: the port
    passes local_files_only, and a directory is never a hub name)."""
    pytest.importorskip("transformers")
    (tmp_path / "empty").mkdir()
    errors = []
    for module in (port_feat, jax_feat):
        with pytest.raises(OSError) as info:
            module.load_dino_extractor(str(tmp_path / "empty"))
        errors.append(type(info.value))
    assert errors[0] is errors[1]
    with pytest.raises(OSError):  # a hub name with nothing cached locally
        port_feat.load_dino_extractor("p2pb-test/no-such-local-model")


def test_extract_image_features_cli_runs_dinov2_on_the_device_asked(tmp_path, monkeypatch,
                                                                   no_network):
    """--encoder dinov2 loads the local checkpoint onto --device (cuda
    unless the caller asks for another); with --device cpu the port's CLI
    writes the root CLI's file."""
    pytest.importorskip("transformers")
    assert feat_cli.parse_args(["--data_root", "x"]).device == "cuda"
    ckpt = tiny_dino_checkpoint(tmp_path / "tiny-dinov2")
    frame_scenes(tmp_path, "depth_shared_K", npoints=120)
    loaded = []
    load = feat_cli.load_dino_extractor
    monkeypatch.setattr(feat_cli, "load_dino_extractor",
                        lambda name, device: loaded.append(device) or load(name, device=device))
    argv = ["--encoder", "dinov2", "--model_name", ckpt, "--feat_dim", "32",
            "--feature_name", "dino"]
    got, want = run_both_clis(tmp_path, monkeypatch, argv, ["--device", "cpu"])
    assert loaded == ["cpu"]
    assert_same(got, want)
    assert got.shape == (32, 120) and got.dtype == np.float16 and np.isfinite(got).all()
