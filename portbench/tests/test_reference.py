"""The plain reference (``portbench/reference``) against the program's plain
versions at TINY sizes on the CPU. The test imports both sides; the
reference itself imports nothing of the program."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny
from portbench.reference import bridge as ref_bridge
from portbench.reference import ops as ref_ops
from portbench.reference import rooms as ref_rooms
from portbench.reference.model import Unet
from portbench.weights import make_state_dict


def cloud(b, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, 3, generator=g)
    return x / x.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]


def both(cfg, seed=3, head_scale=1.0):
    from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config

    state = make_state_dict(cfg, seed, "cpu", head_scale)
    ref, port = Unet(cfg), build_unet_from_config(cfg)
    ref.load_state_dict(state)
    port.load_state_dict(state)
    return ref.eval(), port.eval()


@pytest.mark.parametrize("name,extra", [("PVDS_PUNet", 0), ("PVDL_SNPP", 5)])
def test_forward_equals_the_program_in_f32(name, extra):
    cfg = tiny(name, extra)
    ref, port = both(cfg)
    x = cloud(2, 256)
    cond = torch.randn(2, 256, extra) if extra else None
    t = torch.tensor([3.0, 700.0])
    with torch.no_grad():
        assert torch.allclose(ref(x, t, cond), port(x, t, cond), atol=1e-5, rtol=1e-5)


def test_gradients_equal_the_program_in_f32():
    cfg = tiny("PVDS_PUNet")
    cfg["model"]["dropout"] = 0.0
    ref, port = both(cfg)
    x, t = cloud(2, 256), torch.tensor([10.0, 600.0])
    for model in (ref, port):
        model.train()
        (model(x, t) ** 2).mean().backward()
    port_grads = dict(port.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in port.parameters())
    for k, p in ref.named_parameters():
        # leaves whose gradient is nought but round-off (a bias before a
        # GroupNorm) are held to the largest gradient's scale
        assert torch.allclose(p.grad, port_grads[k].grad, rtol=1e-3, atol=1e-4 * scale), k


def test_point_ops_equal_the_program():
    from p2p_bridge_tpu_torch.ops import (avg_voxelize, knn, nearest_neighbor_interpolate,
                                          normalize_coords_to_voxels, trilinear_devoxelize)
    from p2p_bridge_tpu_torch.ops.ball_query import ball_query, ball_query_group_rel
    from p2p_bridge_tpu_torch.ops.fps import furthest_point_sample_plain

    x = cloud(3, 500, seed=1)
    feats = torch.randn(3, 500, 6)
    assert torch.equal(ref_ops.fps(x, 64), furthest_point_sample_plain(x, 64).long())
    centers = ref_ops.take(x, ref_ops.fps(x, 64))
    assert torch.equal(ref_ops.knn(centers, x, 32), knn(centers, x, 32)[1].long())
    assert torch.equal(ref_ops.ball_query(centers, x, 0.3, 32), ball_query(centers, x, 0.3, 32).long())
    assert torch.equal(ref_ops.group_relative(centers, x, feats, 0.3, 32),
                       ball_query_group_rel(centers, x, feats, 0.3, 32)[0])
    vox, cont = ref_ops.voxel_coords(x, 8)
    pvox, pcont = normalize_coords_to_voxels(x, 8)
    assert torch.equal(vox, pvox.long()) and torch.equal(cont, pcont)
    grid = ref_ops.voxelize(feats, vox, 8)
    assert torch.allclose(grid, avg_voxelize(feats, pvox, 8), atol=1e-6)
    assert torch.allclose(ref_ops.devoxelize(grid, cont, 8), trilinear_devoxelize(grid, cont, 8),
                          atol=1e-6)
    lower = torch.randn(3, 64, 6)
    assert torch.allclose(ref_ops.three_nn_interpolate(x, centers, lower),
                          nearest_neighbor_interpolate(x, centers, lower), atol=1e-6)


def test_sampler_equals_the_program():
    from p2p_bridge_tpu_torch.models.p2pb import P2PBridge

    cfg = tiny("PVDS_PUNet")
    ref, port = both(cfg, head_scale=0.02)
    bridge = P2PBridge.from_config(cfg, port)
    schedule = ref_bridge.Schedule(cfg)
    plan = bridge.schedule.sampler_plan(5)
    got = np.asarray(schedule.plan(5))
    want = np.stack([plan.noise_level_n, plan.std_fwd_n, plan.post_mu_x0, plan.post_mu_xn], 1)
    assert np.allclose(got, want, rtol=1e-6, atol=1e-7)
    x1 = cloud(2, 256, seed=2)
    out = bridge.sample(x1, steps=5, log_count=5)["x_pred"]
    # the reference's coefficients are rounded once from float64, the
    # program's computed in f32: a 1e-7 difference, which the sampler's
    # steps carry to about 1e-3 of the points' displacement
    gap = (ref_bridge.sample(ref, schedule, x1, 5) - out).norm(dim=-1)
    assert float(gap.mean()) < 1e-3 * float((out - x1).norm(dim=-1).mean())


def test_room_patching_equals_the_program():
    from p2p_bridge_tpu_torch import rooms
    from scipy.spatial import cKDTree

    from portbench import generators

    rng = np.random.default_rng(9)
    pts = generators.noisy_room(generators.room_mesh(rng), 4000, 0.015, 0.002, rng)
    seeds = rooms.bucket_fps(pts, 24)
    hoods = [np.asarray(i, np.int64) for i in cKDTree(pts).query_ball_point(pts[seeds], r=0.6)]
    splits = []
    real = rooms.bucket_fps

    def recorded(points, n, seed=0):
        splits.append(real(points, n, seed))
        return splits[-1]

    rooms.bucket_fps = recorded
    try:
        xyz, _, _, idxs, cuts = rooms.create_patches(pts, 256, hoods,
                                                     rng=np.random.default_rng(42))
    finally:
        rooms.bucket_fps = real
    mine = ref_rooms.radius_neighbourhoods(torch.from_numpy(pts), torch.from_numpy(pts[seeds]), 0.6)
    assert all(np.array_equal(a, b) for a, b in zip(mine, hoods))
    plan = ref_rooms.patch_plan(pts, 256, mine, splits, np.random.default_rng(42))
    assert len(plan) == len(xyz) and any(c == 256 for _, _, c in plan)
    for p, (r_xyz, r_idx, r_cut) in enumerate(plan):
        assert np.array_equal(r_xyz, xyz[p]) and np.array_equal(r_idx, idxs[p])
        assert r_cut == cuts[p]
    pool = ref_rooms.fps_pool(len(pts), 24)
    assert set(seeds.tolist()) <= set(pool.tolist())


def test_recomposition_equals_the_program():
    from p2p_bridge_tpu_torch.rooms import RunningMean

    rng = np.random.default_rng(3)
    n = 500
    idxs = rng.integers(0, n, (6, 64))
    cuts = np.asarray([64, 40, 64, 10, 64, 50])
    preds = rng.normal(size=(6, 64, 3)).astype(np.float32)
    acc = RunningMean(rng.normal(size=(n, 3)).astype(np.float32))
    acc.update(preds, idxs, cuts)
    sums, counts = ref_rooms.recompose(n, torch.from_numpy(preds), idxs, cuts)
    held = counts > 0
    want = acc.result()[held.numpy()]
    assert np.allclose((sums[held] / counts[held, None]).float().numpy(), want, atol=1e-6)
