#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:
  1. require a CUDA card, print its name and power limit, turn TF32 off;
  2. build the CUDA kernels from p2p_bridge_tpu_torch/csrc (one nvcc per
     source, in parallel);
  3. hold each kernel against its plain PyTorch version on the card, in
     bf16 and f32, at the shapes that build_pvcnn2_plan gives the
     PVDS_PUNet main path (B = 73 patches of 2048 points), and time the
     kernel, the plain version and, where one PyTorch call computes the
     same function, that call (CUDA events, median of 5 runs after a
     warm-up); the bound of each is the larger of its bytes over 3.35 TB/s
     and its operations over the peak rate of its data type;
  4. build PVDS_PUNet at full width as shipped (bf16, training.amp) and an
     f32 twin with the same weights; hold the f32 forward on the card
     against the f32 forward on the CPU, and the bf16 forward on the card
     against the f32 forward on the card;
  5. denoise one 50,000-point cloud through patch_based_denoise_batch in
     f32 and bf16, each with bucketed and exact recombination; the launch
     counts are set to 0 just before each of the four runs and read just
     after, and every kernel must launch in each;
  6. profile one more bf16 bucketed run with torch.profiler: device time
     by kernel group and the device's idle share.
The line before the last is a JSON object with each kernel's launches,
errors, times and bounds; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.config import pvds_punet
from p2p_bridge_tpu_torch.inference import patch_based_denoise_batch
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.ops import ball_query as bq_ops
from p2p_bridge_tpu_torch.ops import conv3d_gn as conv_ops
from p2p_bridge_tpu_torch.ops import devoxelize as devox_ops
from p2p_bridge_tpu_torch.ops import fps as fps_ops
from p2p_bridge_tpu_torch.ops import interpolate as interp_ops
from p2p_bridge_tpu_torch.ops import voxelize as vox_ops
from p2p_bridge_tpu_torch.ops.common import pairwise_sqdist_exact

PATCHES = 73  # int(3 * 50_000 / 2048)
PATCH = 2048
RUNS = 5
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
MAIN = "bf16"  # PVDS_PUNet as shipped computes in bf16

# the least time the card could take: bytes over the memory rate, operations
# over the peak rate of their type (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}

# tolerances of the kernel-vs-plain comparisons; bf16 results are rounded
# once from an f32 sum on both sides, so where the two f32 sums differ in
# their last bit the rounding can land one bf16 ulp apart: 2^-7 of the
# value at the bottom of a binade, 2^-8 at the top
BF16_ULP = 2.0 ** -7
VOX_TOL = {"f32": 1e-5, "bf16": BF16_ULP}     # times max|features|: f32 atomics
CONV_TOL = {"f32": 1e-4, "bf16": BF16_ULP}    # times max|out|: another f32 order, TF32 off
DEVOX_TOL = {"f32": 1e-6, "bf16": BF16_ULP}   # times max|grid|: same order; the mean in double
INTERP_TOL = {"f32": 1e-6, "bf16": BF16_ULP}  # times max|features|: a 3-term f32 sum
FORWARD_TOL = 1e-3  # abs, times max(1, max|out_cpu|): whole f32 backbone, GPU vs CPU
# relative L2 of the bf16 forward against the f32 forward of the same
# weights on the card: bf16 keeps 8 bits (2^-9 per rounding) and the
# roundings of some 40 normalised layers add up; the CPU tests measured
# 3-6% on a 4x-TINY backbone (tests/test_torch_model.py), so 0.1
BF16_FORWARD_REL_L2 = 0.1

# name -> (file of the kernel, the TPU kernel it replaces)
KERNELS = {
    "fps": ("p2p_bridge_tpu_torch/csrc/fps.cu",
            "p2p_bridge_tpu/ops/pallas/fps_kernel.py:155"),
    "ball_query_group": ("p2p_bridge_tpu_torch/csrc/ball_query_group.cu",
                         "p2p_bridge_tpu/ops/pallas/neighborhood_kernel.py:131"),
    "avg_voxelize": ("p2p_bridge_tpu_torch/csrc/voxelize.cu",
                     "p2p_bridge_tpu/ops/pallas/voxelize_kernel.py:166"),
    "conv3d_gn": ("p2p_bridge_tpu_torch/csrc/conv3d_gn.cu",
                  "p2p_bridge_tpu/ops/pallas/wconv3d_kernel.py:327"),
    "trilinear_devoxelize": ("p2p_bridge_tpu_torch/csrc/devoxelize.cu",
                             "p2p_bridge_tpu/ops/pallas/devox_kernel.py:154"),
    "three_nn_interpolate": ("p2p_bridge_tpu_torch/csrc/interpolate.cu",
                             "p2p_bridge_tpu/ops/pallas/interp_kernel.py:99"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, runs: int = RUNS) -> float:
    """Median device time of ``fn`` over ``runs`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
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


def esize(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


class Tally:
    """Times, bound and error of one kernel in one dtype, summed over the
    calls of one backbone forward."""

    def __init__(self, dtype: str, library: bool):
        self.dtype = dtype
        self.ms = self.plain_ms = self.bound_ms = self.bytes_ms = self.ops_ms = 0.0
        self.library_ms = 0.0 if library else None
        self.err = 0.0

    def add(self, calls, ms, plain_ms, lib_ms, nbytes, ops, err):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[self.dtype] * 1e3
        self.ms += calls * ms
        self.plain_ms += calls * plain_ms
        self.bytes_ms += calls * t_bytes
        self.ops_ms += calls * t_ops
        self.bound_ms += calls * max(t_bytes, t_ops)
        if self.library_ms is not None:
            self.library_ms = None if lib_ms is None else self.library_ms + calls * lib_ms
        self.err = max(self.err, err)
        return max(t_bytes, t_ops)

    def row(self) -> dict:
        return {"ms": self.ms, "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": "bytes" if self.bytes_ms >= self.ops_ms else "operations",
                "library_ms": self.library_ms}


def main_path_shapes(plan, npoints: int) -> dict:
    """The kernel shapes of one backbone forward, from the plan."""
    n, fine = npoints, []
    shapes = {"pvconv": [], "sa": [], "fp": []}
    for stage in plan.sa_stages:
        fine.append(n)
        for spec in stage.convs:
            shapes["pvconv"].append((n, spec.resolution, spec.in_channels, spec.out_channels))
        sa = stage.sa
        shapes["sa"].append((n, sa.num_centers, sa.radius, sa.num_neighbors, sa.in_channels + 3))
        n = sa.num_centers
    for i, stage in enumerate(plan.fp_stages):
        c_interp = stage.fp.in_channels - plan.skip_channels[-1 - i]
        shapes["fp"].append((fine[-1 - i], n, c_interp))
        n = fine[-1 - i]
        for spec in stage.convs:
            shapes["pvconv"].append((n, spec.resolution, spec.in_channels, spec.out_channels))
    return shapes


def counted(items):
    """[(item, calls)] in first-seen order."""
    out: dict = {}
    for it in items:
        out[it] = out.get(it, 0) + 1
    return list(out.items())


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
def check_fps(rng, dev, shapes) -> dict:
    # (what, clouds, points, samples, calls per backbone forward, timed runs)
    cases = [(f"sa{i} centres", PATCHES, n, m, 1, RUNS)
             for i, (n, m, _, _, _) in enumerate(shapes["sa"])]
    cases += [("seeding", 1, 50_000, PATCHES, 0, RUNS),
              ("bucketed recombination", PATCHES, PATCH, 685, 0, RUNS),
              ("exact recombination", 1, PATCHES * PATCH, 50_000, 0, 1)]
    tally = Tally("f32", library=False)
    for what, b, n, m, per_fwd, runs in cases:
        x = patches(rng, b, n, dev)
        got = fps_ops.furthest_point_sample(x, m)
        want = fps_ops.furthest_point_sample_plain(x, m)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"fps {what}: {bad} indices differ from the plain version")
        ms = time_ms(lambda: fps_ops.furthest_point_sample(x, m), runs)
        plain = time_ms(lambda: fps_ops.furthest_point_sample_plain(x, m), runs)
        # per iteration and point: 3 sub, 3 mul, 2 add, min, compare
        bound = tally.add(per_fwd, ms, plain, None, b * n * 12 + b * m * 4,
                          10.0 * b * (m - 1) * n, 0.0)
        log(f"fps {what} [{b}, {n}] -> {m}: indices equal; kernel {ms:.3f} ms, "
            f"plain {plain:.3f} ms, bound {bound:.3g} ms")
    return {"f32": tally}


def check_ball_query(rng, dev, shapes) -> dict:
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=False)
        for n, m, radius, k, c in shapes["sa"]:
            pts = patches(rng, PATCHES, n, dev)
            centers = pts[:, :m].contiguous()
            rows = torch.randn(PATCHES, n, c, device=dev).to(dt)
            rows[..., :3] = pts.to(dt)
            got_g, got_i = bq_ops.ball_query_group(centers, pts, rows, radius, k)
            want_g, want_i = bq_ops.ball_query_group_plain(centers, pts, rows, radius, k)
            torch.cuda.synchronize()
            if not torch.equal(got_i, want_i):
                raise AssertionError(f"ball query {name} {n}->{m}: indices differ")
            if not torch.equal(got_g, want_g):
                raise AssertionError(f"ball query {name} {n}->{m}: gathered rows differ")
            ms = time_ms(lambda: bq_ops.ball_query_group(centers, pts, rows, radius, k))
            plain = time_ms(lambda: bq_ops.ball_query_group_plain(centers, pts, rows, radius, k))
            # the scan stops at the warp of the K-th hit: count what it reads
            hits = (pairwise_sqdist_exact(centers, pts) < bq_ops._radius_sq(radius)).cumsum(-1)
            kth = torch.where(hits[..., -1] >= k, (hits < k).sum(-1), torch.full_like(hits[..., -1], n))
            scanned = torch.clamp((kth // 32 + 1) * 32, max=n).sum().item()
            nbytes = (PATCHES * (m + n) * 12 + PATCHES * n * c * esize(dt)
                      + PATCHES * m * k * (c * esize(dt) + 4))
            bound = tally.add(1, ms, plain, None, nbytes, 8.0 * scanned, 0.0)
            log(f"ball_query_group {name} {n}->{m} r={radius} C={c}: idx and rows equal; "
                f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bound:.3g} ms")
            del hits
        out[name] = tally
    return out


def check_voxelize(rng, dev, shapes) -> dict:
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=True)
        for (n, r, c), calls in counted((n, r, cin) for n, r, cin, _ in shapes["pvconv"]):
            pts = patches(rng, PATCHES, n, dev)
            vox, _ = vox_ops.normalize_coords_to_voxels(pts, r)
            feat = torch.randn(PATCHES, n, c, device=dev).to(dt)
            got = vox_ops.avg_voxelize(feat, vox, r)
            want = vox_ops.avg_voxelize_plain(feat, vox, r)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = VOX_TOL[name] * feat.float().abs().max().item()
            if not (got.dtype == dt and err <= tol):
                raise AssertionError(f"voxelize {name} N={n} r={r} C={c}: max err {err} > {tol}")
            ms = time_ms(lambda: vox_ops.avg_voxelize(feat, vox, r))
            plain = time_ms(lambda: vox_ops.avg_voxelize_plain(feat, vox, r))
            idx = vox_ops.flat_voxel_index(vox, r).long()[..., None].expand(PATCHES, n, c)
            grid = torch.zeros(PATCHES, r ** 3, c, device=dev, dtype=dt)
            lib = time_ms(lambda: grid.scatter_reduce_(1, idx, feat, "mean", include_self=False))
            nbytes = PATCHES * n * (c * esize(dt) + 12) + PATCHES * r ** 3 * c * esize(dt)
            bound = tally.add(calls, ms, plain, lib, nbytes,
                              PATCHES * (n + r ** 3) * c, err)
            log(f"avg_voxelize {name} N={n} r={r} C={c} x{calls}: max err {err:.3g} "
                f"(tol {tol:.3g}); kernel {ms:.3f} ms, plain {plain:.3f} ms, "
                f"scatter_reduce_ {lib} ms, bound {bound:.3g} ms")
        out[name] = tally
    return out


def check_conv3d_gn(rng, dev, shapes) -> dict:
    convs = []
    for _, r, cin, cout in shapes["pvconv"]:  # vconv1 (swish), vconv2
        convs += [(r, cin, cout, True), (r, cout, cout, False)]
    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, dt in DTYPES.items():
        tally = Tally(name, library=True)
        for i, ((r, cin, cout, act), calls) in enumerate(counted(convs)):
            x = torch.randn(PATCHES, r, r, r, cin, device=dev, generator=gen).to(dt)
            w = (torch.randn(3, 3, 3, cin, cout, device=dev, generator=gen)
                 / (27 * cin) ** 0.5).to(dt)
            b = 0.1 * torch.randn(cout, device=dev, generator=gen)
            gamma = 1 + 0.1 * torch.randn(PATCHES, cout, device=dev, generator=gen)
            beta = 0.1 * torch.randn(PATCHES, cout, device=dev, generator=gen)
            if i % 3 == 2:  # also the shared [C] affine of plain GroupNorm
                gamma, beta = gamma[0].contiguous(), beta[0].contiguous()
            got = conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act)
            want = conv_ops.conv3d_gn_plain(x, w, b, gamma, beta, 8, 1e-5, act)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = CONV_TOL[name] * want.float().abs().max().item()
            if not (got.dtype == dt and err <= tol):
                raise AssertionError(f"conv3d_gn {name} r={r} {cin}->{cout}: max err {err} > {tol}")
            del got, want
            ms = time_ms(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act))
            plain = time_ms(lambda: conv_ops.conv3d_gn_plain(x, w, b, gamma, beta, 8, 1e-5, act))
            # cuDNN conv + GroupNorm on channels-first tensors made outside the timing
            xc = x.permute(0, 4, 1, 2, 3).contiguous()
            wc = w.permute(4, 3, 0, 1, 2).contiguous()
            bc = b.to(dt)
            ga = gamma.to(dt).expand(PATCHES, cout)[:, :, None, None, None]
            be = beta.to(dt).expand(PATCHES, cout)[:, :, None, None, None]

            def library():
                y = F.group_norm(F.conv3d(xc, wc, bc, padding=1), 8, eps=1e-5) * ga + be
                return F.silu(y) if act else y

            lib = time_ms(library)
            del xc
            flop = 2.0 * PATCHES * r ** 3 * 27 * cin * cout
            nbytes = (PATCHES * r ** 3 * (cin + cout) + 27 * cin * cout) * esize(dt)
            bound = tally.add(calls, ms, plain, lib, nbytes, flop, err)
            log(f"conv3d_gn {name} r={r} {cin}->{cout} x{calls} B={PATCHES}: max err {err:.3g} "
                f"(tol {tol:.3g}); kernel {ms:.3f} ms ({flop / ms / 1e9:.2f} TFLOP/s), "
                f"plain {plain:.3f} ms, cuDNN {lib} ms, bound {bound:.3g} ms")
            del x
            torch.cuda.empty_cache()
        out[name] = tally
    return out


def check_devoxelize(rng, dev, shapes) -> dict:
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=True)
        for (n, r, c), calls in counted((n, r, cout) for n, r, _, cout in shapes["pvconv"]):
            pts = patches(rng, PATCHES, n, dev)
            _, cont = vox_ops.normalize_coords_to_voxels(pts, r)
            grid = torch.randn(PATCHES, r, r, r, c, device=dev).to(dt)
            got, got_m = devox_ops.trilinear_devoxelize_with_mean(grid, cont, r)
            want = devox_ops.trilinear_devoxelize_plain(grid, cont, r)
            want_m = devox_ops.grid_mean_plain(grid)
            torch.cuda.synchronize()
            err = max((got.float() - want.float()).abs().max().item(),
                      (got_m - want_m).abs().max().item())
            tol = DEVOX_TOL[name] * grid.float().abs().max().item()
            if not (got.dtype == dt and got_m.dtype == torch.float32 and err <= tol):
                raise AssertionError(f"devoxelize {name} N={n} r={r} C={c}: max err {err} > {tol}")
            ms = time_ms(lambda: devox_ops.trilinear_devoxelize_with_mean(grid, cont, r))
            plain = time_ms(lambda: (devox_ops.trilinear_devoxelize_plain(grid, cont, r),
                                     devox_ops.grid_mean_plain(grid)))
            # F.grid_sample on [B, C, D, H, W] at (x, y, z) = (k, j, i) in [-1, 1]
            gc = grid.permute(0, 4, 1, 2, 3).contiguous()
            loc = (cont.flip(-1) / (r - 1) * 2 - 1).to(dt).view(PATCHES, 1, 1, n, 3)
            lib = time_ms(lambda: F.grid_sample(gc, loc, mode="bilinear", align_corners=True))
            nbytes = (PATCHES * r ** 3 * c * esize(dt) + PATCHES * n * 12
                      + PATCHES * n * c * esize(dt) + PATCHES * c * 4)
            ops = PATCHES * n * (8 * 2 * c + 24) + PATCHES * r ** 3 * c
            bound = tally.add(calls, ms, plain, lib, nbytes, ops, err)
            log(f"trilinear_devoxelize {name} N={n} r={r} C={c} x{calls}: max err {err:.3g} "
                f"(tol {tol:.3g}); kernel {ms:.3f} ms, plain {plain:.3f} ms, "
                f"grid_sample {lib} ms, bound {bound:.3g} ms")
            del gc
        out[name] = tally
    return out


def check_interpolate(rng, dev, shapes) -> dict:
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=False)
        for n, m, c in shapes["fp"]:
            pts = patches(rng, PATCHES, n, dev)
            centers = pts[:, :m].contiguous()  # coarse points are a subset
            feat = torch.randn(PATCHES, m, c, device=dev).to(dt)
            got, got_w, got_i = interp_ops.three_nn_interpolate(pts, centers, feat)
            want, want_w, want_i = interp_ops.three_nn_interpolate_plain(pts, centers, feat)
            torch.cuda.synchronize()
            if not torch.equal(got_i, want_i):
                raise AssertionError(f"three_nn {name} {n}<-{m}: indices differ")
            err_w = (got_w - want_w).abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            tol = INTERP_TOL[name] * feat.float().abs().max().item()
            if not (got.dtype == dt and err_w <= 1e-6 and err <= tol):
                raise AssertionError(f"three_nn {name} {n}<-{m}: weights {err_w}, out {err} > {tol}")
            # the model's form, which skips the weight and index stores
            alone = interp_ops.nearest_neighbor_interpolate(pts, centers, feat)
            if not torch.equal(alone, got):
                raise AssertionError(f"three_nn {name} {n}<-{m}: the sum alone differs")
            ms = time_ms(lambda: interp_ops.nearest_neighbor_interpolate(pts, centers, feat))
            plain = time_ms(lambda: interp_ops.three_nn_interpolate_plain(pts, centers, feat))
            nbytes = PATCHES * (n + m) * 12 + PATCHES * (m + n) * c * esize(dt)
            # per (point, centre) pair: 3 sub, 3 mul, 2 add
            bound = tally.add(1, ms, plain, None, nbytes, 8.0 * PATCHES * n * m, err)
            log(f"three_nn_interpolate {name} {n}<-{m} C={c}: indices equal, weights {err_w:.3g}, "
                f"max err {err:.3g} (tol {tol:.3g}); kernel {ms:.3f} ms, plain {plain:.3f} ms, "
                f"bound {bound:.3g} ms")
        out[name] = tally
    return out


def check_kernels(dev, plan) -> dict:
    rng = np.random.default_rng(0)
    shapes = main_path_shapes(plan, PATCH)
    log(f"main path shapes at B={PATCHES}: {json.dumps(shapes)}")
    results = {
        "fps": check_fps(rng, dev, shapes),
        "ball_query_group": check_ball_query(rng, dev, shapes),
        "avg_voxelize": check_voxelize(rng, dev, shapes),
        "conv3d_gn": check_conv3d_gn(rng, dev, shapes),
        "trilinear_devoxelize": check_devoxelize(rng, dev, shapes),
        "three_nn_interpolate": check_interpolate(rng, dev, shapes),
    }
    for name, per_dtype in results.items():
        for dtype, tally in per_dtype.items():
            row = tally.row()
            log(f"{name} {dtype}: per backbone forward at B={PATCHES}: kernel {row['ms']:.3f} ms, "
                f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), library {row['library_ms']}")
    return results


# ---------------------------------------------------------------- phase 4
def build_models(device):
    """(PVDS_PUNet as shipped, computing in bf16; its f32 twin)."""
    cfg = pvds_punet()
    model = build_unet_from_config(cfg).eval()
    init_parameters(model, torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in model.parameters())
    if n != 26_441_155 or model.dtype != torch.bfloat16:
        raise AssertionError(f"PVDS_PUNet: {n} parameters in {model.dtype}, "
                             "expected 26,441,155 computing in bf16")
    cfg["model"]["compute_dtype"] = "f32"
    twin = build_unet_from_config(cfg).eval()
    twin.load_state_dict(model.state_dict())
    log(f"PVDS_PUNet: {n:,} parameters, computing in bf16 as shipped; f32 twin")
    return model.to(device), twin.to(device)


def check_forward(model, twin, dev) -> dict:
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.stack([surface_cloud(rng, PATCH) for _ in range(2)]))
    t = torch.from_numpy(np.array([700.0, 300.0], np.float32))
    cfg = pvds_punet()
    cfg["model"]["compute_dtype"] = "f32"
    cpu_model = build_unet_from_config(cfg).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in twin.state_dict().items()})
    with torch.no_grad():
        want = cpu_model(x, t).numpy()
        got32 = twin(x.to(dev), t.to(dev)).cpu().numpy()
        got16 = model(x.to(dev), t.to(dev)).cpu().numpy()
    err = float(np.abs(got32 - want).max())
    tol = FORWARD_TOL * max(1.0, float(np.abs(want).max()))
    log(f"f32 forward [2, {PATCH}, 3] card vs CPU: max err {err:.3g} (tol {tol:.3g}), "
        f"max|out| {np.abs(want).max():.3g}")
    if not (np.isfinite(got32).all() and err <= tol):
        raise AssertionError(f"card forward differs from the CPU forward: {err} > {tol}")
    rel = float(np.linalg.norm(got16 - got32) / np.linalg.norm(got32))
    log(f"bf16 forward vs f32 forward on the card: relative L2 {rel:.4g} "
        f"(bound {BF16_FORWARD_REL_L2}), max abs {np.abs(got16 - got32).max():.3g}")
    if not (np.isfinite(got16).all() and got16.shape == got32.shape
            and rel <= BF16_FORWARD_REL_L2):
        raise AssertionError(f"bf16 forward: relative L2 {rel} > {BF16_FORWARD_REL_L2}")
    return {"f32_card_vs_cpu_max_abs": err, "bf16_vs_f32_rel_l2": rel}


# ---------------------------------------------------------------- phase 5
def cloud_50k() -> np.ndarray:
    rng = np.random.default_rng(0)
    pcl = rng.normal(size=(1, 50_000, 3)).astype(np.float32)
    return pcl / np.linalg.norm(pcl, axis=-1, keepdims=True).max(axis=1, keepdims=True)


def denoise(bridge, pcl, mode, dev) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out, _ = patch_based_denoise_batch(bridge, pcl, patch_size=PATCH, seed_k=3, steps=5,
                                       recombine_mode=mode, device=dev)
    end.record()
    torch.cuda.synchronize()
    if out.shape != (1, 50_000, 3) or not np.isfinite(out).all():
        raise AssertionError(f"{mode}: output {out.shape}, finite {np.isfinite(out).all()}")
    return start.elapsed_time(end)


def denoise_50k(model, twin, dev) -> dict:
    """{dtype: {mode: {"ms", "launches"}}}. Each of the four paths runs
    with the counts set to 0 just before it and read just after, and must
    launch every kernel; each dtype warms up once (bucketed) first."""
    pcl = cloud_50k()
    runs = {}
    for name, net in (("f32", twin), ("bf16", model)):
        bridge = P2PBridge.from_config(pvds_punet(), net)
        denoise(bridge, pcl, "bucketed", dev)  # warm-up
        runs[name] = {}
        for mode in ("bucketed", "exact"):
            kernels.reset_launch_counts()
            ms = denoise(bridge, pcl, mode, dev)
            launches = dict(kernels.launch_counts)
            log(f"denoise 50,000 points, {name}, 73 patches x 2048, 5 steps, {mode} "
                f"recombination: {ms:.1f} ms ({50_000 / ms * 1e3:.0f} points/s); "
                f"launches {launches}")
            idle = [k for k in KERNELS if launches.get(k, 0) == 0]
            if idle:
                raise AssertionError(f"kernels not launched on the {name} {mode} path: {idle}")
            runs[name][mode] = {"ms": ms, "launches": launches}
    return runs


# ---------------------------------------------------------------- phase 6
# device kernels of each hand-written kernel, by function name
KERNEL_FUNCTIONS = {
    "conv3d_gn": ("conv_tile_kernel", "conv_mma_kernel", "gn_stats_kernel", "gn_apply_kernel"),
    "avg_voxelize": ("scatter_kernel", "divide_kernel"),
    "trilinear_devoxelize": ("devox_kernel", "mean_partial_kernel", "mean_final_kernel"),
    "ball_query_group": ("ball_query_group_kernel",),
    "fps": ("fps_kernel",),
    "three_nn_interpolate": ("three_nn_interp_kernel",),
}


def kernel_group(name: str) -> str:
    for group, fns in KERNEL_FUNCTIONS.items():
        if any(f"(anonymous namespace)::{fn}" in name for fn in fns):
            return group
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "library GEMMs"
    return "other PyTorch kernels"


def profile_bf16(model, dev) -> dict:
    """torch.profiler over one bf16 bucketed 50k run: device time by
    kernel group and the idle share (1 - union of kernel/copy/set
    intervals / host wall time of the traced call)."""
    from torch.profiler import ProfilerActivity, profile

    bridge = P2PBridge.from_config(pvds_punet(), model)
    pcl = cloud_50k()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        denoise(bridge, pcl, "bucketed", dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    spans, groups = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((e["ts"], e["ts"] + e["dur"]))
            total, calls = groups.get(kernel_group(e["name"]), (0.0, 0))
            groups[kernel_group(e["name"])] = (total + e["dur"] / 1e3, calls + 1)
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    log(f"profile bf16 bucketed: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"idle share {1.0 - busy_ms / wall_ms:.4f}")
    for g, (ms, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {ms:9.2f} ms ({100 * ms / wall_ms:5.1f}% of wall) in {calls:5d} kernels: {g}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms_by_group": {g: v[0] for g, v in groups.items()}}


def main() -> None:
    require_card()
    dev = torch.device("cuda", 0)
    build_kernels()
    with torch.device("meta"):
        plan = build_unet_from_config(pvds_punet()).plan
    results = check_kernels(dev, plan)
    model, twin = build_models(dev)
    forward = check_forward(model, twin, dev)
    run = denoise_50k(model, twin, dev)
    profile = profile_bf16(model, dev)

    entries = []
    for name, (src, replaces) in KERNELS.items():
        per_dtype = results[name]
        dtype = MAIN if MAIN in per_dtype else "f32"  # fps: f32 coordinates on both paths
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": run[MAIN]["bucketed"]["launches"][name],
                 "launches_by_path": {f"{d} {m}": r["launches"][name]
                                      for d, modes in run.items() for m, r in modes.items()},
                 "max_abs_err": max(t.err for t in per_dtype.values()),
                 **per_dtype[dtype].row(), "dtype": dtype,
                 "max_abs_err_by_dtype": {d: t.err for d, t in per_dtype.items()},
                 "f32": per_dtype["f32"].row(),
                 "timed": f"kernel calls of one PVDS_PUNet forward at B={PATCHES}"}
        entries.append(entry)
    line = {"kernels": entries, "forward": forward,
            "denoise_50k_ms": {f"{d} {m}": r["ms"] for d, modes in run.items()
                               for m, r in modes.items()},
            "profile_bf16_bucketed": profile}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
