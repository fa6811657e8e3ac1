#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:
  1. require a CUDA card, print its name and power limit, turn TF32 off;
  2. build the CUDA kernels from p2p_bridge_tpu_torch/csrc;
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of the PVDS_PUNet main path, and time both (CUDA events,
     median of 5 runs after a warm-up);
  4. build PVDS_PUNet at full width in f32, check its parameter count, and
     hold one forward on the card (kernels) against the same forward on the
     CPU (plain versions);
  5. denoise one 50,000-point cloud through patch_based_denoise_batch with
     bucketed and exact recombination, and check that every kernel of the
     path was launched.
The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.config import pvds_punet
from p2p_bridge_tpu_torch.inference import patch_based_denoise_batch
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.ops import ball_query as bq_ops
from p2p_bridge_tpu_torch.ops import conv3d_gn as conv_ops
from p2p_bridge_tpu_torch.ops import fps as fps_ops
from p2p_bridge_tpu_torch.ops import voxelize as vox_ops

PATCHES = 73  # int(3 * 50_000 / 2048)
PATCH = 2048
RUNS = 5

# tolerances of the kernel-vs-plain comparisons
VOX_TOL = 1e-5    # abs, times max|features|: f32 atomics sum in any order
CONV_TOL = 1e-4   # abs, times max|out|: another f32 summation order, TF32 off
FORWARD_TOL = 1e-3  # abs, times max(1, max|out_cpu|): whole backbone, GPU vs CPU

# (name, file of the kernel, the TPU kernel it replaces)
KERNELS = {
    "fps": ("p2p_bridge_tpu_torch/csrc/fps.cu",
            "p2p_bridge_tpu/ops/pallas/fps_kernel.py:155"),
    "ball_query_group": ("p2p_bridge_tpu_torch/csrc/ball_query_group.cu",
                         "p2p_bridge_tpu/ops/pallas/neighborhood_kernel.py:131"),
    "avg_voxelize": ("p2p_bridge_tpu_torch/csrc/voxelize.cu",
                     "p2p_bridge_tpu/ops/pallas/voxelize_kernel.py:166"),
    "conv3d_gn": ("p2p_bridge_tpu_torch/csrc/conv3d_gn.cu",
                  "p2p_bridge_tpu/ops/pallas/wconv3d_kernel.py:327"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn) -> float:
    """Median device time of ``fn`` over RUNS calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def surface_cloud(rng: np.random.Generator, n: int, noise: float = 0.01) -> np.ndarray:
    """n points on a unit sphere plus gaussian noise, unit-sphere normalised."""
    p = rng.normal(size=(n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    p += noise * rng.normal(size=(n, 3))
    p -= p.mean(0)
    p /= np.linalg.norm(p, axis=1).max()
    return p.astype(np.float32)


def patches(rng, b: int, n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.stack([surface_cloud(rng, n) for _ in range(b)])).to(device)


# ---------------------------------------------------------------- phase 1
def require_card() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)  # name and power limit, as nvidia-smi gives them
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ---------------------------------------------------------------- phase 2
def build_kernels() -> None:
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {path}")


# ---------------------------------------------------------------- phase 3
def check_fps(rng, dev, results) -> None:
    # (what, clouds, points, samples, calls per backbone forward)
    cases = [
        ("sa0 centres", PATCHES, 2048, 512, 1),
        ("sa1 centres", PATCHES, 512, 128, 1),
        ("sa2 centres", PATCHES, 128, 32, 1),
        ("sa3 centres", PATCHES, 32, 8, 1),
        ("seeding", 1, 50_000, PATCHES, 0),
        ("bucketed recombination", PATCHES, PATCH, 685, 0),
        ("exact recombination", 1, PATCHES * PATCH, 50_000, 0),
    ]
    fwd_ms = fwd_plain = 0.0
    for what, b, n, m, per_fwd in cases:
        x = patches(rng, b, n, dev)
        got = fps_ops.furthest_point_sample(x, m)
        want = fps_ops.furthest_point_sample_plain(x, m)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"fps {what}: {bad} indices differ from the plain version")
        ms = time_ms(lambda: fps_ops.furthest_point_sample(x, m))
        plain = time_ms(lambda: fps_ops.furthest_point_sample_plain(x, m))
        log(f"fps {what} [{b}, {n}] -> {m}: indices equal; "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
        fwd_ms += per_fwd * ms
        fwd_plain += per_fwd * plain
    results["fps"] = {"max_abs_err": 0.0, "ms": fwd_ms, "plain_ms": fwd_plain}


def check_ball_query(rng, dev, results) -> None:
    cases = [(2048, 512, 0.1, 35), (512, 128, 0.2, 67), (128, 32, 0.4, 131),
             (32, 8, 0.8, 323)]
    fwd_ms = fwd_plain = 0.0
    for n, m, radius, c in cases:
        pts = patches(rng, PATCHES, n, dev)
        centers = pts[:, :m].contiguous()
        rows = torch.randn(PATCHES, n, c, device=dev)
        rows[..., :3] = pts
        got_g, got_i = bq_ops.ball_query_group(centers, pts, rows, radius, 32)
        want_g, want_i = bq_ops.ball_query_group_plain(centers, pts, rows, radius, 32)
        torch.cuda.synchronize()
        if not torch.equal(got_i, want_i):
            raise AssertionError(f"ball query {n}->{m}: indices differ")
        if not torch.equal(got_g, want_g):
            raise AssertionError(f"ball query {n}->{m}: gathered rows differ")
        ms = time_ms(lambda: bq_ops.ball_query_group(centers, pts, rows, radius, 32))
        plain = time_ms(lambda: bq_ops.ball_query_group_plain(centers, pts, rows, radius, 32))
        log(f"ball_query_group {n}->{m} r={radius} C={c}: idx and rows equal; "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
        fwd_ms += ms
        fwd_plain += plain
    results["ball_query_group"] = {"max_abs_err": 0.0, "ms": fwd_ms, "plain_ms": fwd_plain}


def check_voxelize(rng, dev, results) -> None:
    # (points, r, C) of every PVConv voxelization in one forward
    cases = [(2048, 32, 35), (512, 16, 128), (128, 8, 192), (32, 8, 256),
             (128, 8, 256), (512, 16, 128), (512, 16, 128), (2048, 32, 64)]
    fwd_ms = fwd_plain = 0.0
    worst = 0.0
    for n, r, c in cases:
        pts = patches(rng, PATCHES, n, dev)
        vox, _ = vox_ops.normalize_coords_to_voxels(pts, r)
        feat = torch.randn(PATCHES, n, c, device=dev)
        got = vox_ops.avg_voxelize(feat, vox, r)
        want = vox_ops.avg_voxelize_plain(feat, vox, r)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = VOX_TOL * feat.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"voxelize N={n} r={r} C={c}: max err {err} > {tol}")
        worst = max(worst, err)
        ms = time_ms(lambda: vox_ops.avg_voxelize(feat, vox, r))
        plain = time_ms(lambda: vox_ops.avg_voxelize_plain(feat, vox, r))
        log(f"avg_voxelize N={n} r={r} C={c}: max err {err:.3g} (tol {tol:.3g}); "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
        fwd_ms += ms
        fwd_plain += plain
    results["avg_voxelize"] = {"max_abs_err": worst, "ms": fwd_ms, "plain_ms": fwd_plain}


def check_conv3d_gn(rng, dev, results) -> None:
    # (r, Cin, Cout, calls per forward); act alternates as vconv1/vconv2 do
    cases = [(32, 35, 32, 1), (32, 32, 32, 1), (32, 64, 64, 2),
             (16, 128, 64, 1), (16, 64, 64, 1), (16, 128, 128, 4),
             (8, 192, 128, 1), (8, 128, 128, 1), (8, 256, 256, 4)]
    fwd_ms = fwd_plain = 0.0
    worst = 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    for i, (r, cin, cout, per_fwd) in enumerate(cases):
        x = torch.randn(PATCHES, r, r, r, cin, device=dev, generator=gen)
        w = torch.randn(3, 3, 3, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5
        b = 0.1 * torch.randn(cout, device=dev, generator=gen)
        gamma = 1 + 0.1 * torch.randn(PATCHES, cout, device=dev, generator=gen)
        beta = 0.1 * torch.randn(PATCHES, cout, device=dev, generator=gen)
        if i % 3 == 2:  # also the shared [C] affine of plain GroupNorm
            gamma, beta = gamma[0].contiguous(), beta[0].contiguous()
        act = i % 2 == 0
        got = conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act)
        want = conv_ops.conv3d_gn_plain(x, w, b, gamma, beta, 8, 1e-5, act)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = CONV_TOL * want.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"conv3d_gn r={r} {cin}->{cout}: max err {err} > {tol}")
        worst = max(worst, err)
        ms = time_ms(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act))
        plain = time_ms(lambda: conv_ops.conv3d_gn_plain(x, w, b, gamma, beta, 8, 1e-5, act))
        flop = 2 * PATCHES * r ** 3 * 27 * cin * cout
        log(f"conv3d_gn r={r} {cin}->{cout} B={PATCHES}: max err {err:.3g} (tol {tol:.3g}); "
            f"kernel {ms:.3f} ms ({flop / ms / 1e9:.2f} TFLOP/s), plain {plain:.3f} ms")
        fwd_ms += per_fwd * ms
        fwd_plain += per_fwd * plain
        del x, got, want
    results["conv3d_gn"] = {"max_abs_err": worst, "ms": fwd_ms, "plain_ms": fwd_plain}


def check_kernels(dev) -> dict:
    rng = np.random.default_rng(0)
    results: dict = {}
    check_fps(rng, dev, results)
    check_ball_query(rng, dev, results)
    check_voxelize(rng, dev, results)
    check_conv3d_gn(rng, dev, results)
    for name, r in results.items():
        log(f"{name}: per backbone forward at B={PATCHES}: kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms")
    return results


# ---------------------------------------------------------------- phase 4
def build_model(device) -> torch.nn.Module:
    cfg = pvds_punet()
    model = build_unet_from_config(cfg).eval()
    init_parameters(model, torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in model.parameters())
    if n != 26_441_155:
        raise AssertionError(f"PVDS_PUNet has {n} parameters, expected 26,441,155")
    log(f"PVDS_PUNet: {n:,} parameters, f32")
    return model.to(device)


def check_forward(model, dev) -> None:
    rng = np.random.default_rng(1)
    x = np.stack([surface_cloud(rng, PATCH) for _ in range(2)])
    t = np.array([700.0, 300.0], np.float32)
    cpu_model = build_unet_from_config(pvds_punet()).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        want = cpu_model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        got = model(torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)).cpu().numpy()
    err = float(np.abs(got - want).max())
    tol = FORWARD_TOL * max(1.0, float(np.abs(want).max()))
    log(f"forward [2, {PATCH}, 3] card vs CPU: max err {err:.3g} (tol {tol:.3g}), "
        f"max|out| {np.abs(want).max():.3g}")
    if not (np.isfinite(got).all() and err <= tol):
        raise AssertionError(f"card forward differs from the CPU forward: {err} > {tol}")


# ---------------------------------------------------------------- phase 5
def denoise_50k(model, dev) -> dict:
    rng = np.random.default_rng(0)
    pcl = rng.normal(size=(1, 50_000, 3)).astype(np.float32)
    pcl /= np.linalg.norm(pcl, axis=-1, keepdims=True).max(axis=1, keepdims=True)
    bridge = P2PBridge.from_config(pvds_punet(), model)
    kw = dict(patch_size=PATCH, seed_k=3, steps=5, device=dev)
    patch_based_denoise_batch(bridge, pcl, recombine_mode="bucketed", **kw)  # warm-up

    kernels.reset_launch_counts()
    times = {}
    for mode in ("bucketed", "exact"):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, _ = patch_based_denoise_batch(bridge, pcl, recombine_mode=mode, **kw)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        times[mode] = ms
        if out.shape != (1, 50_000, 3) or not np.isfinite(out).all():
            raise AssertionError(f"{mode}: output {out.shape}, finite {np.isfinite(out).all()}")
        log(f"denoise 50,000 points, 73 patches x 2048, 5 steps, {mode} recombination: "
            f"{ms:.1f} ms ({50_000 / ms * 1e3:.0f} points/s)")
    launches = dict(kernels.launch_counts)
    log(f"launches in the two runs: {launches}")
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    return {"launches": launches, "ms": times}


def main() -> None:
    require_card()
    dev = torch.device("cuda", 0)
    build_kernels()
    results = check_kernels(dev)
    model = build_model(dev)
    check_forward(model, dev)
    run = denoise_50k(model, dev)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": run["launches"][name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "timed": f"kernel calls of one PVDS_PUNet forward at B={PATCHES}"}
        for name, (src, replaces) in KERNELS.items()],
        "denoise_50k_ms": run["ms"]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
