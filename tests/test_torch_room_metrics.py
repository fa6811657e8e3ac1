"""The port's room metrics (Chamfer, chunked nearest neighbours, point <->
mesh distance, the facade and the evaluate_rooms CLI) against the JAX
package on the CPU, inputs from numpy seeds.

Tolerances: both sides compute in f32. A Chamfer distance is a min over
|a|^2 + |b|^2 - 2ab, whose terms the two frameworks sum in other orders:
1 ulp of |a|^2 + |b|^2, which is up to 5e-7 for the clouds here (|p| up to
about 2; a unit-sphere-normalised cloud lies within 1), so single
distances agree to 1e-6 absolute and the indices exactly on these seeds
(no two candidates within 1e-6 of each other). Means over thousands of
points and the point <-> triangle distances (closed form, the same
operations) agree to 1e-5 relative.
"""

import argparse
import csv
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import evaluate_rooms as jax_evaluate_rooms

from p2p_bridge_tpu.metrics import chamfer as jax_chamfer
from p2p_bridge_tpu.metrics import metrics as jax_metrics
from p2p_bridge_tpu.metrics import p2m as jax_p2m
from p2p_bridge_tpu.ops.knn import nn_distance_chunked as jax_nn
from p2p_bridge_tpu_torch import evaluate_rooms
from p2p_bridge_tpu_torch.metrics import chamfer, metrics, p2m
from p2p_bridge_tpu_torch.metrics.metrics import cd_large_pair, point_face_dist
from p2p_bridge_tpu_torch.ops.knn import nn_distance_chunked
from p2p_bridge_tpu_torch.utils.io import read_ply, write_ply

DIST_ATOL = 1e-6
MEAN_RTOL = 1e-5


def clouds(seed, *sizes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in sizes]


def test_chamfer_distance_matches_jax():
    x, y = clouds(0, (2, 300, 3), (2, 257, 3))
    got = chamfer.chamfer_distance(torch.from_numpy(x), torch.from_numpy(y))
    want = jax_chamfer.chamfer_distance(jnp.asarray(x), jnp.asarray(y))
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=DIST_ATOL)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_chamfer_distance_ties_take_the_lowest_index():
    x = torch.zeros(1, 2, 3)
    y = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0]]])
    d_xy, d_yx, i_xy, i_yx = chamfer.chamfer_distance(x, y)
    assert i_xy.tolist() == [[0, 0]] and i_yx.tolist() == [[0, 0, 0]]
    assert d_xy.tolist() == [[1.0, 1.0]]


@pytest.mark.parametrize("chunk", [128, 1000])
def test_nn_distance_chunked_matches_jax(chunk):
    """The port streams a ragged last chunk; the JAX scan needs the points
    padded to a multiple of ``chunk`` with far sentinels. Both give the same
    distances and indices, and the port's padded and unpadded calls agree."""
    q, p = clouds(1, (700, 3), (3000, 3), scale=0.5)
    padded = np.pad(p, ((0, (-len(p)) % chunk), (0, 0)), constant_values=1e18)
    got_d, got_i = nn_distance_chunked(torch.from_numpy(q), torch.from_numpy(p), chunk)
    want_d, want_i = jax_nn(jnp.asarray(q), jnp.asarray(padded), chunk)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=DIST_ATOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i.dtype == torch.int32
    pad_d, pad_i = nn_distance_chunked(torch.from_numpy(q), torch.from_numpy(padded), chunk)
    np.testing.assert_array_equal(pad_d.numpy(), got_d.numpy())
    np.testing.assert_array_equal(pad_i.numpy(), got_i.numpy())


def test_nn_distance_chunked_keeps_the_earlier_chunk_on_a_tie():
    p = torch.tensor([[1.0, 0, 0], [5.0, 5, 5], [1.0, 0, 0], [5.0, 5, 5]])
    d, i = nn_distance_chunked(torch.zeros(1, 3), p, 2)
    assert i.tolist() == [0] and d.tolist() == [1.0]


def test_chamfer_distance_large_matches_jax_and_brute_force():
    """About 20k x 15k points with chunk 2048 and query_chunk 5000: both
    directions take several target and query chunks, the last of each
    ragged (the JAX package pads them)."""
    x, y = clouds(2, (20_011, 3), (15_003, 3), scale=0.5)
    kw = dict(chunk=2048, query_chunk=5000)
    got = chamfer.chamfer_distance_large(x, y, device="cpu", **kw)
    want = jax_chamfer.chamfer_distance_large(x, y, **kw)
    exact = (cKDTree(y).query(x)[0] ** 2, cKDTree(x).query(y)[0] ** 2)
    for g, w, e in zip(got, want, exact):
        assert g.shape == w.shape == e.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=DIST_ATOL)
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-5)  # the matrix form's cancellation


def test_cuda_entry_points_raise_without_a_card():
    """--device cuda never falls back to the CPU."""
    x, y = clouds(3, (50, 3), (40, 3))
    faces = np.array([[0, 1, 2]])
    if torch.cuda.is_available():
        chamfer.chamfer_distance_large(x, y)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        chamfer.chamfer_distance_large(x, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.cd_large_pair(x, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        p2m.point_mesh_face_distance(x, y, faces)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.point_face_dist(x, y, faces)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.cd_unit_sphere(x[None], y[None])


def box_mesh(rng, n=12):
    """A closed box surface of (n-1)^2 * 12 triangles, ragged by noise, and
    points near it."""
    g = np.linspace(-0.5, 0.5, n)
    u, v = np.meshgrid(g, g, indexing="ij")
    verts, faces = [], []
    for axis in range(3):
        for side in (-0.5, 0.5):
            face = np.zeros((n, n, 3))
            face[..., axis] = side
            face[..., (axis + 1) % 3] = u
            face[..., (axis + 2) % 3] = v
            base = sum(len(x) for x in verts)
            verts.append(face.reshape(-1, 3))
            for i in range(n - 1):
                for j in range(n - 1):
                    a = base + i * n + j
                    faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    verts = np.concatenate(verts) + rng.normal(size=(6 * n * n, 3)) * 0.01
    return (verts * [2.0, 1.0, 0.5]).astype(np.float32), np.asarray(faces)


def test_point_triangle_sqdist_matches_jax():
    rng = np.random.default_rng(4)
    p, v0, v1, v2 = (rng.normal(size=(500, 3)).astype(np.float32) for _ in range(4))
    v2[:50] = v0[:50]  # degenerate triangles
    got = p2m.point_triangle_sqdist(*(torch.from_numpy(a) for a in (p, v0, v1, v2)))
    want = jax_p2m.point_triangle_sqdist(*(jnp.asarray(a) for a in (p, v0, v1, v2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MEAN_RTOL, atol=DIST_ATOL)


def test_point_mesh_face_distance_matches_jax():
    """Candidate chunks of 700 (several per direction) and 32 candidates."""
    rng = np.random.default_rng(5)
    verts, faces = box_mesh(rng)
    idx = rng.integers(0, len(verts), 3000)
    points = (verts[idx] + rng.normal(size=(3000, 3)) * 0.02).astype(np.float32)
    got = p2m.point_mesh_face_distance(points, verts, faces, chunk=700, device="cpu")
    want = jax_p2m.point_mesh_face_distance(points, verts, faces, chunk=700)
    np.testing.assert_allclose(got, want, rtol=MEAN_RTOL)
    assert all(isinstance(v, float) and v > 0 for v in got)


def test_normalize_sphere_matches_jax():
    (pc,) = clouds(6, (3, 400, 3), scale=5.0)
    got = metrics.normalize_sphere(torch.from_numpy(pc + 2.0), radius=0.5)
    want = jax_metrics.normalize_sphere(pc + 2.0, radius=0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    back = metrics.normalize_pcl(torch.from_numpy(pc + 2.0), got[1], got[2])
    np.testing.assert_allclose(back.numpy(), got[0].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("layout", ["bnc", "bcn"])
def test_cd_unit_sphere_matches_jax(normalize, layout):
    gen, ref = clouds(7, (2, 500, 3), (2, 450, 3), scale=3.0)
    if layout == "bcn":  # the facade takes [B, 3, N] too
        gen, ref = gen.transpose(0, 2, 1).copy(), ref.transpose(0, 2, 1).copy()
    got = metrics.cd_unit_sphere(gen, ref, normalize=normalize, device="cpu")
    want = jax_metrics.cd_unit_sphere(gen, ref, normalize=normalize)
    np.testing.assert_allclose(got, want, rtol=MEAN_RTOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_point_face_dist_matches_jax(normalize):
    rng = np.random.default_rng(8)
    verts, faces = box_mesh(rng)
    pcl = (verts[rng.integers(0, len(verts), 2000)] * 1.05 + 3.0).astype(np.float32)
    verts = verts + 3.0
    got = metrics.point_face_dist(pcl, verts, faces, normalize=normalize, device="cpu")
    want = jax_metrics.point_face_dist(pcl, verts, faces, normalize=normalize)
    np.testing.assert_allclose(got, want, rtol=MEAN_RTOL)


def test_cd_large_pair_matches_jax():
    pred, gt = clouds(9, (9000, 3), (7000, 3), scale=0.5)
    got = metrics.cd_large_pair(pred, gt, device="cpu")
    want = jax_metrics.cd_large_pair(pred, gt)
    np.testing.assert_allclose(got, want, rtol=MEAN_RTOL)
    assert all(isinstance(v, float) for v in got)


# ---------------------------------------------------------------- the CLI
def box_scene(root, rng):
    """A ScanNet++ evaluation tree: a box mesh, a scan of 2,000 points near
    it, and predictions: two of the scan's size, one larger (FPS-sampled
    down to the scan's size) and one smaller (skipped)."""
    verts, faces = box_mesh(rng)
    scans = root / "scene0" / "scans"
    scans.mkdir(parents=True)
    write_ply(str(scans / "mesh_aligned_0.05.ply"), verts, faces=faces)

    def near(n, sigma):
        return verts[rng.integers(0, len(verts), n)] + rng.normal(size=(n, 3)) * sigma

    write_ply(str(scans / "iphone.ply"), near(2000, 0.02))
    model = root / "scene0" / "predictions" / "P2SB"
    model.mkdir(parents=True)
    for name, n, sigma in (("a", 2000, 0.01), ("b", 2000, 0.005), ("c", 2600, 0.01),
                           ("d", 1500, 0.01)):
        write_ply(str(model / f"{name}.ply"), near(n, sigma))
    return model


@pytest.mark.parametrize("normalize", [False, True])
def test_evaluate_rooms_cli_matches_the_library_and_jax(tmp_path, normalize):
    """The CSV holds one row a prediction (the smaller one skipped) with
    the library's metrics x 10^3, and agrees with the root CLI (JAX,
    pandas) on its columns and rows, and on its values within the
    tolerances of tests/test_torch_room_metrics.py; a second run computes
    nothing new; a new prediction is appended."""
    rng = np.random.default_rng(12)
    port_model = box_scene(tmp_path / "port", rng)
    jax_root = tmp_path / "jax"
    shutil.copytree(tmp_path / "port", jax_root)
    flags = ["--dataset", "snpp", "--device", "cpu"] + (["--normalize"] if normalize else [])
    evaluate_rooms.main(["--data_root", str(tmp_path / "port"), *flags])
    name = "metrics.csv_normalized.csv" if normalize else "metrics.csv"

    def rows(model):
        with open(model / name, newline="") as f:
            return list(csv.DictReader(f))

    got = rows(port_model)
    assert list(got[0]) == evaluate_rooms.COLUMNS
    assert sorted(r["model_config"] for r in got) == ["a", "b", "c"]

    mesh = read_ply(str(port_model.parent.parent / "scans" / "mesh_aligned_0.05.ply"))
    pred = read_ply(str(port_model / "a.ply"))["points"]
    a = next(r for r in got if r["model_config"] == "a")
    pd, fd = point_face_dist(pred, mesh["points"], mesh["faces"], normalize=normalize,
                             device="cpu")
    assert float(a["point_dist"]) == pd * 1e3 and float(a["face_dist"]) == fd * 1e3
    if not normalize:
        cd = cd_large_pair(pred, mesh["points"], device="cpu")
        assert (float(a["cd_pred_gt"]), float(a["cd_gt_pred"])) == (cd[0] * 1e3, cd[1] * 1e3)

    args = argparse.Namespace(dataset="snpp", normalize=normalize, suffix="")
    for scene_dir in sorted(jax_root.iterdir()):
        jax_evaluate_rooms.handle_scene(str(scene_dir), args)
    want = {r["model_config"]: r for r in rows(jax_root / "scene0" / "predictions" / "P2SB")}
    assert {r["model_config"] for r in got} == set(want)
    for r in got:
        w = want[r["model_config"]]
        for col in ("point_dist", "face_dist"):  # closed form, the same operations
            np.testing.assert_allclose(float(r[col]), float(w[col]), rtol=1e-5, err_msg=col)
        for col in ("cd_pred_gt", "cd_gt_pred"):  # 1e-6 a squared distance, x 10^3
            np.testing.assert_allclose(float(r[col]), float(w[col]), rtol=0, atol=1e-3,
                                       err_msg=col)

    if normalize:  # the skip-if-done rule reads metrics.csv, which --normalize never writes
        return
    before = (port_model / name).read_text()
    evaluate_rooms.main(["--data_root", str(tmp_path / "port"), *flags])
    assert (port_model / name).read_text() == before
    write_ply(str(port_model / "e.ply"), pred)
    evaluate_rooms.main(["--data_root", str(tmp_path / "port"), *flags])
    assert (port_model / name).read_text().startswith(before)
    assert [r["model_config"] for r in rows(port_model)][-1] == "e"


def test_evaluate_rooms_cli_requires_cuda_when_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_rooms.main(["--data_root", str(tmp_path), "--dataset", "snpp"])


def test_arkit_rows_have_no_mesh_distances(tmp_path):
    rng = np.random.default_rng(13)
    model = box_scene(tmp_path, rng)
    scans = tmp_path / "scene0" / "scans"
    (scans / "mesh_aligned_0.05.ply").rename(scans / "faro.ply")
    evaluate_rooms.main(["--data_root", str(tmp_path), "--dataset", "arkit", "--device", "cpu"])
    text = (model / "metrics.csv").read_text().splitlines()
    assert text[0] == ",".join(evaluate_rooms.COLUMNS)
    assert len(text) == 5 and all(line.split(",")[1:3] == ["", ""] for line in text[1:])
