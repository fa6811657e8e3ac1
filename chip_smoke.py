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
     warm-up, each run up to 20 back-to-back calls; K1 also one call per
     run); the bound of each is the larger of its bytes over 3.35 TB/s and
     its operations over the peak rate of its data type; K1 also at B = 1
     and B = 3 (a cloud's first and last tiles, an odd tile count) and at
     the rooms model's Cout = 512 (two channel tiles);
  4. build PVDS_PUNet at full width as shipped (bf16, training.amp) and an
     f32 twin with the same weights; hold the f32 forward on the card
     against the f32 forward on the CPU, and the bf16 forward on the card
     against the f32 forward on the card;
  5. denoise one 50,000-point cloud through patch_based_denoise_batch in
     f32 and bf16, each with bucketed and exact recombination; the launch
     counts are set to 0 just before each of the four runs and read just
     after, and every kernel must launch in each;
  6. profile one more bf16 bucketed run with torch.profiler: device time
     by kernel group and the device's idle share;
  7. training: hold the two training kernels, K2b (voxelize backward) in
     bf16 and f32 and K7 (auction EMD) on the distances of a real batch,
     against their plain versions at the training shapes (B = 32 patches
     of 2048 points), and time them; hold the f32 gradient of the loss at
     full width on the card against the CPU's (B = 2, dropout off, fixed
     timesteps); train PVDS_PUNet as shipped (bf16, AdamW, clip 1.0, EMA,
     the K7 alignment) for 31 steps through ``train`` on a synthetic PUNet
     tree written with numpy: every loss finite, the last five below the
     first five, the launch counts set to 0 just before step 20 and read
     just after with all eight kernels launched, ms per step over steps
     10-29 split into its phases, a torch.profiler profile of step 30; and
     a checkpoint that denoise_object.load_weights reads back into a model
     with a bit-equal forward.
The line before the last is a JSON object with each kernel's launches,
errors, times and bounds; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch import denoise_object
from p2p_bridge_tpu_torch.config import pvds_punet
from p2p_bridge_tpu_torch.data.batch import get_data_batch
from p2p_bridge_tpu_torch.data.dataloader import get_dataloader
from p2p_bridge_tpu_torch.inference import patch_based_denoise_batch
from p2p_bridge_tpu_torch.metrics import emd_auction
from p2p_bridge_tpu_torch.models.model_loader import save_checkpoint
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.train import train
from p2p_bridge_tpu_torch.ops import ball_query as bq_ops
from p2p_bridge_tpu_torch.ops import conv3d_gn as conv_ops
from p2p_bridge_tpu_torch.ops import devoxelize as devox_ops
from p2p_bridge_tpu_torch.ops import fps as fps_ops
from p2p_bridge_tpu_torch.ops import interpolate as interp_ops
from p2p_bridge_tpu_torch.ops import voxelize as vox_ops
from p2p_bridge_tpu_torch.ops.common import pairwise_sqdist, pairwise_sqdist_exact

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
    "avg_voxelize_backward": ("p2p_bridge_tpu_torch/csrc/voxelize.cu",
                              "p2p_bridge_tpu/ops/pallas/voxelize_kernel.py:255"),
    "auction_emd": ("p2p_bridge_tpu_torch/csrc/auction.cu",
                    "p2p_bridge_tpu/ops/pallas/auction_kernel.py:120"),
}
SERVING = ("fps", "ball_query_group", "avg_voxelize", "conv3d_gn", "trilinear_devoxelize",
           "three_nn_interpolate")  # the kernels of the denoising path
TRAIN_B = 32  # training.bs of PVDS_PUNet
TRAIN_STEPS = 31  # steps 10-29 timed, 20 counted, 30 profiled
POOL_SIZE = 96  # data.pool_size cut from 2048: the pool fills before step 0
# The f32 loss and gradient, card vs CPU (TF32 off). The two devices sum
# in other orders, and the GroupNorms amplify that: at r = 32 most of the
# 32,768 voxels of a 2048-point patch are empty, so a group's spread is
# small and the few occupied voxels normalise to large values. The loss
# then differs by 1.7e-5 relative, the whole gradient by 2.5e-4 relative
# L2, and single parameters whose gradient cancels by up to 4.1e-3, while
# two card runs agree far closer (the check prints both). A wrong backward
# moves the parameters it touches by O(1).
LOSS_REL = 1e-4
GRAD_REL_L2 = 1e-3  # the whole gradient
PARAM_REL_L2 = 1e-2  # every parameter


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, runs: int = RUNS, back_to_back: bool = True) -> float:
    """Median device time of one call of ``fn`` over ``runs`` timed runs
    after a warm-up. A run makes as many back-to-back calls as fill about
    5 ms (at most 20), so that the host's launch work for one call overlaps
    the device's work on the one before; a call of 5 ms or more runs alone,
    and so does every call without ``back_to_back`` (the host's launch
    work of a call is then inside its time)."""
    def run(reps: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    fn()
    torch.cuda.synchronize()
    reps = int(min(20, max(1, 5.0 // run(1)))) if back_to_back else 1
    return float(np.median([run(reps) for _ in range(runs)]))


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
        self.single_call_ms = None  # K1: one call per timed run
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
        row = {"ms": self.ms, "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "bound_by": "bytes" if self.bytes_ms >= self.ops_ms else "operations",
               "library_ms": self.library_ms}
        if self.single_call_ms is not None:
            row["single_call_ms"] = self.single_call_ms
        return row


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


def conv_inputs(gen, dev, dt, B, r, cin, cout, shared):
    """x, w, bias, gamma, beta of one conv3d_gn call: w scaled so that the
    conv has unit variance; per-cloud [B, C] affine, or shared [C]."""
    x = torch.randn(B, r, r, r, cin, device=dev, generator=gen).to(dt)
    w = (torch.randn(3, 3, 3, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5).to(dt)
    b = 0.1 * torch.randn(cout, device=dev, generator=gen)
    gamma = 1 + 0.1 * torch.randn(B, cout, device=dev, generator=gen)
    beta = 0.1 * torch.randn(B, cout, device=dev, generator=gen)
    if shared:
        gamma, beta = gamma[0].contiguous(), beta[0].contiguous()
    return x, w, b, gamma, beta


def conv_error(name, args, act, what) -> tuple:
    """K1 against its plain version on the same inputs; raises above the
    tolerance."""
    got = conv_ops.conv3d_gn(*args, 8, 1e-5, act)
    want = conv_ops.conv3d_gn_plain(*args, 8, 1e-5, act)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = CONV_TOL[name] * want.float().abs().max().item()
    if not (got.dtype == args[0].dtype and got.shape == want.shape and err <= tol):
        raise AssertionError(f"conv3d_gn {name} {what}: max err {err} > {tol}")
    return err, tol


def check_conv3d_gn(rng, dev, shapes) -> dict:
    convs = []
    for _, r, cin, cout in shapes["pvconv"]:  # vconv1 (swish), vconv2
        convs += [(r, cin, cout, True), (r, cout, cout, False)]
    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, dt in DTYPES.items():
        tally = Tally(name, library=True)
        tally.single_call_ms = 0.0
        for i, ((r, cin, cout, act), calls) in enumerate(counted(convs)):
            # i % 3 == 2: also the shared [C] affine of plain GroupNorm
            x, w, b, gamma, beta = conv_inputs(gen, dev, dt, PATCHES, r, cin, cout, i % 3 == 2)
            err, tol = conv_error(name, (x, w, b, gamma, beta), act, f"r={r} {cin}->{cout}")
            ms = time_ms(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act))
            single = time_ms(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act),
                             back_to_back=False)
            tally.single_call_ms += calls * single
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
                f"(tol {tol:.3g}); kernel {ms:.3f} ms ({flop / ms / 1e9:.2f} TFLOP/s, "
                f"{bound / ms:.3f} of the bound {bound:.3g} ms), one call alone {single:.3f} ms, "
                f"plain {plain:.3f} ms, cuDNN conv + GroupNorm {lib:.3f} ms")
            del x
            torch.cuda.empty_cache()
        out[name] = tally
    # a cloud's first and last tiles alone (B = 1) and an odd tile count
    # (B = 3); Cout = 512 (PVDL_SNPP's widest conv) takes two channel tiles
    for B in (1, 3):
        for r, cin, cout, act in ((8, 256, 256, False), (32, 35, 32, True), (8, 512, 512, True)):
            for shared in (False, True):
                args = conv_inputs(gen, dev, torch.bfloat16, B, r, cin, cout, shared)
                err, tol = conv_error("bf16", args, act, f"B={B} r={r} {cin}->{cout}")
                out["bf16"].err = max(out["bf16"].err, err)
                log(f"conv3d_gn bf16 B={B} r={r} {cin}->{cout} "
                    f"{'shared' if shared else 'per-cloud'} affine: max err {err:.3g} (tol {tol:.3g})")
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
            idle = [k for k in SERVING if launches.get(k, 0) == 0]
            if idle:
                raise AssertionError(f"kernels not launched on the {name} {mode} path: {idle}")
            runs[name][mode] = {"ms": ms, "launches": launches}
    return runs


# ---------------------------------------------------------------- phase 6
# device kernels of each hand-written kernel, by function name
KERNEL_FUNCTIONS = {
    "conv3d_gn": ("conv_tile_kernel", "conv_wgmma_kernel", "gn_stats_kernel", "gn_apply_kernel",
                  "gn_apply_bf16_kernel"),
    "avg_voxelize": ("scatter_kernel", "divide_kernel"),
    "trilinear_devoxelize": ("devox_kernel", "mean_partial_kernel", "mean_final_kernel"),
    "ball_query_group": ("ball_query_group_kernel",),
    "fps": ("fps_kernel",),
    "three_nn_interpolate": ("three_nn_interp_kernel",),
    "avg_voxelize_backward": ("gather_divide_kernel",),
    "auction_emd": ("auction_kernel",),
}


def kernel_group(name: str) -> str:
    for group, fns in KERNEL_FUNCTIONS.items():
        if any(f"(anonymous namespace)::{fn}" in name for fn in fns):
            return group
    if any(k in name.lower() for k in ("fprop", "dgrad", "wgrad", "cudnn", "conv")):
        return "cuDNN convolutions (K1's backward)"
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
    return device_time(prof, wall_ms, "bf16 bucketed")


def device_time(prof, wall_ms: float, what: str) -> dict:
    """Device time by kernel group of a finished torch.profiler run and the
    idle share: 1 - union of kernel/copy/set intervals / host wall time."""
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
    log(f"profile {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"idle share {1.0 - busy_ms / wall_ms:.4f}")
    for g, (ms, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {ms:9.2f} ms ({100 * ms / wall_ms:5.1f}% of wall) in {calls:5d} kernels: {g}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms_by_group": {g: v[0] for g, v in groups.items()}}


# ---------------------------------------------------------------- phase 7
def synthetic_punet(root: Path, rng) -> None:
    """A PUNet tree of three shapes (bumpy sphere, ellipsoid, torus) at
    the three training resolutions, plus the 10k test split the loader
    opens, each cloud normalised to the unit sphere."""
    def shape(kind, n):
        if kind == "torus":
            u, v = rng.uniform(0, 2 * np.pi, (2, n))
            p = np.stack([(0.7 + 0.3 * np.cos(v)) * np.cos(u),
                          (0.7 + 0.3 * np.cos(v)) * np.sin(u), 0.3 * np.sin(v)], 1)
        else:
            d = rng.normal(size=(n, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            if kind == "ellipsoid":
                p = d * np.array([1.0, 0.7, 0.5])
            else:
                p = d * (1.0 + 0.15 * np.sin(3 * d[:, :1]) * np.cos(2 * d[:, 1:2]))
        p -= p.mean(0)
        return (p / np.linalg.norm(p, axis=1).max()).astype(np.float32)

    for split, sizes in (("train", (10_000, 30_000, 50_000)), ("test", (10_000,))):
        for n in sizes:
            d = root / "PUNet" / "pointclouds" / split / f"{n}_poisson"
            d.mkdir(parents=True)
            for kind in ("bumpy_sphere", "ellipsoid", "torus"):
                np.savetxt(d / f"{kind}.xyz", shape(kind, n), fmt="%.6f")


def train_config(data_dir: Path, out_dir: Path) -> dict:
    """PVDS_PUNet as shipped, on the synthetic tree, for TRAIN_STEPS steps."""
    cfg = pvds_punet()
    cfg["data"]["data_dir"] = str(data_dir)
    cfg["data"]["pool_size"] = POOL_SIZE
    cfg["training"]["steps"] = TRAIN_STEPS
    cfg["output_dir"] = str(out_dir)
    return cfg


def check_voxelize_backward(rng, dev, shapes) -> dict:
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=True)
        for (n, r, c), calls in counted((n, r, cin) for n, r, cin, _ in shapes["pvconv"]):
            pts = patches(rng, TRAIN_B, n, dev)
            vox, _ = vox_ops.normalize_coords_to_voxels(pts, r)
            idx = vox_ops.flat_voxel_index(vox, r).int()
            cnt = torch.zeros(TRAIN_B, r ** 3, device=dev).scatter_add_(
                1, idx.long(), torch.ones(TRAIN_B, n, device=dev))
            g = torch.randn(TRAIN_B, r ** 3, c, device=dev).to(dt)
            got = vox_ops.avg_voxelize_backward(g, idx, cnt)
            want = vox_ops.avg_voxelize_backward_plain(g, idx, cnt)
            torch.cuda.synchronize()
            if not (got.dtype == dt and torch.equal(got, want)):
                bad = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"voxelize backward {name} r={r} C={c}: differs by {bad}")
            ms = time_ms(lambda: vox_ops.avg_voxelize_backward(g, idx, cnt))
            plain = time_ms(lambda: vox_ops.avg_voxelize_backward_plain(g, idx, cnt))
            # library: torch.gather of the rows, then the divide (two calls)
            rows_idx = idx.long()[..., None].expand(TRAIN_B, n, c)
            den = torch.gather(cnt, 1, idx.long()).clamp_min(1.0)[..., None]
            lib = time_ms(lambda: torch.gather(g, 1, rows_idx) / den)
            touched = torch.unique(idx.long() + torch.arange(TRAIN_B, device=dev)[:, None] * r ** 3)
            nbytes = (touched.numel() * (c * esize(dt) + 4) + TRAIN_B * n * 4
                      + TRAIN_B * n * c * esize(dt))
            bound = tally.add(calls, ms, plain, lib, nbytes, TRAIN_B * n * c, 0.0)
            log(f"avg_voxelize_backward {name} N={n} r={r} C={c} x{calls} B={TRAIN_B}: "
                f"bit-equal; kernel {ms:.4f} ms, plain {plain:.4f} ms, gather + divide "
                f"(2 calls) {lib:.4f} ms, bound {bound:.4g} ms")
        out[name] = tally
    return out


def aligned_batch(cfg: dict, dev) -> dict:
    """One training batch of the synthetic tree through the port's loader."""
    loader, _ = get_dataloader(cfg)
    try:
        batch = get_data_batch(next(iter(loader)), cfg)
    finally:
        loader.stop()
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if v is not None}


def check_auction(batch: dict, dev) -> dict:
    """K7 on the distances of a real batch (noisy onto clean), as the
    alignment calls it (eps 0.01, 100 rounds), then with 3 and 1 rounds so
    that points are left to the greedy fallback."""
    d2 = pairwise_sqdist(batch["x_start"], batch["x_gt"]).contiguous()
    B, N, M = d2.shape
    tally = Tally("f32", library=False)
    for iters in (100, 3, 1):
        dist, assign, stats = emd_auction._auction_emd_cuda(d2, 0.01, iters)
        want_d, want_a = emd_auction.auction_emd_plain(d2, 0.01, iters)
        torch.cuda.synchronize()
        if not (torch.equal(assign, want_a) and torch.equal(dist, want_d)):
            raise AssertionError(f"auction {iters} rounds: {(assign != want_a).sum().item()} "
                                 "assignments differ from the plain version")
        rounds, rows, left = (int(v) for v in stats.sum(0).tolist())
        log(f"auction_emd B={B} N={N} M={M} eps 0.01 {iters} rounds: assign and dist equal; "
            f"rounds max {stats[:, 0].max().item()}, bidder rows {rows}, fallback points {left}")
        if iters == 100:
            ms = time_ms(lambda: emd_auction.auction_emd_assign(d2, 0.01, iters))
            plain = time_ms(lambda: emd_auction.auction_emd_plain(d2, 0.01, iters), runs=2)
            # d2 read once, outputs written once; per scanned element a
            # subtract, a compare and a max
            nbytes = B * N * M * 4 + B * N * 8
            bound = tally.add(1, ms, plain, None, nbytes, 3.0 * (rows + left) * M, 0.0)
            log(f"auction_emd kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bound:.4g} ms "
                f"({B * N * M * 4 / 1e6:.0f} MB of d2; {rows + left} row scans)")
        elif left == 0:
            raise AssertionError(f"auction {iters} rounds left no point to the fallback")
    return {"f32": tally}


def check_gradient(dev) -> dict:
    """The f32 loss and every parameter's gradient, card vs CPU."""
    cfg = pvds_punet()
    cfg["model"]["compute_dtype"] = "f32"
    cfg["model"]["dropout"] = 0.0
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(np.stack([surface_cloud(rng, PATCH) for _ in range(2)]))
    x1 = x0 + 0.02 * torch.from_numpy(rng.normal(size=x0.shape).astype(np.float32))
    steps = torch.tensor([700, 300])
    cpu = build_unet_from_config(cfg).train()
    init_parameters(cpu, torch.Generator().manual_seed(0))
    card = build_unet_from_config(cfg).train()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    want = P2PBridge.from_config(cfg, cpu).loss_fn(x0, x1, steps=steps)
    want.backward()
    runs = []
    for _ in range(2):  # twice: how far the card is from itself
        card.zero_grad(set_to_none=True)
        got = P2PBridge.from_config(cfg, card).loss_fn(x0.to(dev), x1.to(dev),
                                                       steps=steps.to(dev))
        got.backward()
        runs.append([p.grad.cpu() for p in card.parameters()])
    again = (sum((a - b).norm() ** 2 for a, b in zip(*runs)) ** 0.5
             / sum(b.norm() ** 2 for b in runs[1]) ** 0.5).item()
    loss_err = abs(got.item() - want.item()) / abs(want.item())
    worst, worst_name, zero, sq_diff, sq_ref = 0.0, None, 0, 0.0, 0.0
    for (name, pc), pg in zip(cpu.named_parameters(), runs[1]):
        ref = pc.grad.norm().item()
        diff = (pg - pc.grad).norm().item()
        sq_diff, sq_ref = sq_diff + diff ** 2, sq_ref + ref ** 2
        rel = diff / ref if ref > 0 else diff
        zero += ref == 0
        if rel > worst:
            worst, worst_name = rel, name
    total = (sq_diff / sq_ref) ** 0.5
    log(f"f32 gradient at full width, B=2, card vs CPU: loss {want.item():.6f}, relative "
        f"{loss_err:.3g} (bound {LOSS_REL}); whole gradient relative L2 {total:.3g} (bound "
        f"{GRAD_REL_L2}); worst parameter {worst_name}: relative L2 {worst:.3g} (bound "
        f"{PARAM_REL_L2}); {zero} parameters with a zero gradient; two card runs: "
        f"relative L2 {again:.3g}")
    if not (math.isfinite(got.item()) and loss_err <= LOSS_REL and total <= GRAD_REL_L2
            and worst <= PARAM_REL_L2):
        raise AssertionError(f"card gradient differs from the CPU: loss {loss_err}, whole "
                             f"{total}, {worst_name} {worst}")
    return {"loss_rel": loss_err, "grad_rel_l2": total, "worst_param": worst_name,
            "worst_param_rel_l2": worst, "card_vs_card_rel_l2": again}


class TrainObserver:
    """The ``train`` observer: CUDA events at every phase of steps 10-29,
    the launch counts of step 20, a profile of step 30, every loss."""

    PHASES = ("begin", "batch", "align", "forward_backward", "update")

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.events, self.losses, self.launches = {}, [], None
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.profile = None
        self.t0 = 0.0

    def __call__(self, step, event, metrics):
        if event == "begin" and step == 20:
            kernels.reset_launch_counts()
        if event == "begin" and step == TRAIN_STEPS - 1:
            torch.cuda.synchronize()
            self.prof.start()
            self.t0 = time.perf_counter()
        if 10 <= step < 30 and event in self.PHASES:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.setdefault(step, {})[event] = e
        if event == "end":
            self.losses.append(metrics["loss"])
            if step == 20:
                self.launches = dict(kernels.launch_counts)
            if step == TRAIN_STEPS - 1:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - self.t0) * 1e3
                self.prof.stop()
                self.profile = device_time(self.prof, wall, "one bf16 train step")


def train_phase(cfg: dict, dev) -> tuple:
    obs = TrainObserver()
    t0 = time.perf_counter()
    state = train(cfg, dev, observer=obs)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    losses = [float(v) for v in obs.losses]
    log(f"trained {TRAIN_STEPS} steps of PVDS_PUNet (bf16, bs {TRAIN_B} x {PATCH}, AdamW, "
        f"clip 1.0, EMA, K7 alignment) in {total_s:.1f} s, data.pool_size cut to {POOL_SIZE}; "
        f"losses {[round(v, 5) for v in losses]}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"training losses: {losses}")
    if not last < first:
        raise AssertionError(f"mean loss of the last five steps {last} >= first five {first}")
    idle = [k for k in KERNELS if obs.launches.get(k, 0) == 0]
    log(f"launches in step 20: {obs.launches}")
    if idle:
        raise AssertionError(f"kernels not launched in a training step: {idle}")
    spans = {"data": ("begin", "batch"), "align": ("batch", "align"),
             "forward_backward": ("align", "forward_backward"),
             "optimizer_ema": ("forward_backward", "update"), "step": ("begin", "update")}
    split = {name: float(np.median([ev[a].elapsed_time(ev[b]) for ev in obs.events.values()]))
             for name, (a, b) in spans.items()}
    log(f"ms per step, median of steps 10-29 (CUDA events): {split['step']:.2f} "
        f"({TRAIN_B / split['step'] * 1e3:.1f} patches/s); data {split['data']:.2f}, "
        f"alignment {split['align']:.2f}, forward + backward {split['forward_backward']:.2f}, "
        f"optimizer + EMA {split['optimizer_ema']:.2f}")
    return state, {"losses": losses, "first5_mean": first, "last5_mean": last,
                   "launches": obs.launches, "ms": split,
                   "patches_per_s": TRAIN_B / split["step"] * 1e3, "profile": obs.profile}


def check_checkpoint(state, cfg: dict, batch: dict) -> dict:
    """save_checkpoint -> denoise_object.load_weights into fresh models,
    with and without --use_ema: every tensor equal to the trained one, and
    a bit-equal forward on one cloud. The forwards run on the CPU: K2's f32
    atomics make two card forwards of the same weights differ in the last
    bits."""
    x = batch["x_start"][:1].cpu()
    t = torch.tensor([700.0])
    trained = {True: state.ema.params, False: state.model.state_dict()}
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(tmp, state)
        for use_ema, params in trained.items():
            ref = build_unet_from_config(cfg).eval()
            ref.load_state_dict({k: v.cpu() for k, v in params.items()})
            fresh = build_unet_from_config(cfg).eval()
            denoise_object.load_weights(fresh, path, use_ema=use_ema)
            same = all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                        ref.state_dict().values()))
            with torch.no_grad():
                got, want = fresh(x, t), ref(x, t)
            if not (same and torch.equal(got, want)):
                raise AssertionError(f"checkpoint round trip (use_ema={use_ema}): weights equal "
                                     f"{same}, forward differs by {(got - want).abs().max()}")
    log("checkpoint round trip: save_checkpoint -> denoise_object.load_weights, with and "
        "without --use_ema: weights equal, forwards bit-equal (CPU, 1 x 2048)")
    return {"bit_equal": True}


def training(dev, plan) -> dict:
    shapes = main_path_shapes(plan, PATCH)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        synthetic_punet(root / "data", np.random.default_rng(3))
        log(f"synthetic PUNet tree written in {time.perf_counter() - t0:.1f} s")
        cfg = train_config(root / "data", root / "run")
        batch = aligned_batch(cfg, dev)
        results = {"avg_voxelize_backward": check_voxelize_backward(
            np.random.default_rng(4), dev, shapes), "auction_emd": check_auction(batch, dev)}
        gradient = check_gradient(dev)
        state, run = train_phase(cfg, dev)
        checkpoint = check_checkpoint(state, cfg, batch)
    return {"results": results, "gradient": gradient, "run": run, "checkpoint": checkpoint}


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
    del model, twin
    torch.cuda.empty_cache()
    trained = training(dev, plan)
    results.update(trained["results"])
    train_launches = trained["run"]["launches"]

    entries = []
    for name, (src, replaces) in KERNELS.items():
        per_dtype = results[name]
        dtype = MAIN if MAIN in per_dtype else "f32"  # fps, auction: f32 on both paths
        by_path = {f"{d} {m}": r["launches"].get(name, 0)
                   for d, modes in run.items() for m, r in modes.items()}
        by_path["bf16 train step"] = train_launches[name]
        serving = name in SERVING
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": by_path[f"{MAIN} bucketed" if serving else "bf16 train step"],
                 "launches_by_path": by_path,
                 "max_abs_err": max(t.err for t in per_dtype.values()),
                 **per_dtype[dtype].row(), "dtype": dtype,
                 "max_abs_err_by_dtype": {d: t.err for d, t in per_dtype.items()},
                 "f32": per_dtype["f32"].row(),
                 "timed": (f"kernel calls of one PVDS_PUNet forward at B={PATCHES}" if serving
                           else f"kernel calls of one PVDS_PUNet training step at B={TRAIN_B}")}
        entries.append(entry)
    line = {"kernels": entries, "forward": forward,
            "denoise_50k_ms": {f"{d} {m}": r["ms"] for d, modes in run.items()
                               for m, r in modes.items()},
            "profile_bf16_bucketed": profile,
            "train": {"gradient": trained["gradient"], "checkpoint": trained["checkpoint"],
                      **{k: v for k, v in trained["run"].items() if k != "launches"}}}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
