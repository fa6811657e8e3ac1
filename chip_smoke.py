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
     run); beside each kernel's time, its device time per call (its own
     device functions in a torch.profiler trace of 10 back-to-back calls)
     and its host time per call (the host clock over up to 300 calls with
     no synchronise); the bound of each is the larger of its bytes over
     3.35 TB/s and its operations over the peak rate of its data type;
     K5 (FPS) indices torch.equal to the plain version at the SA stages
     and the bucketed recombination (one block per cloud), and at the
     seeding, the exact recombination [1 and 4, 149,504] -> 50,000 and a
     ragged [1, 100,003] -> 33,000 whose every pick is a tie (one 16-CTA
     cluster per cloud), the one-block kernel timed at the exact shape, and
     both kernels at B = 1 for growing N (the dispatch's crossover);
     K1 also at B = 1 and B = 3 (a cloud's first and last tiles, an odd
     tile count) and at the rooms model's Cout = 512 (two channel tiles);
     K2 (voxelize) torch.equal, grid and counts, to its plain version run
     on the CPU from the same inputs and to a second kernel call, also at
     PVDL_SNPP's (4096, 32, 67) and (64, 8, 512) at B = 4; then the host
     cost of K2b's wrapper, of its launch and of the pieces of the launch
     path, this one's and the earlier one's;
  4. build PVDS_PUNet at full width as shipped (bf16, training.amp) and an
     f32 twin with the same weights; hold the f32 forward on the card
     against the f32 forward on the CPU, and the bf16 forward on the card
     against the f32 forward on the card; two bf16 forwards at B = 73 of
     the same weights and inputs must be bit-equal (where not, the error
     names the first module whose output varies);
  5. denoise one 50,000-point cloud through patch_based_denoise_batch in
     f32 and bf16, each with bucketed and exact recombination; the launch
     counts are set to 0 just before each of the four runs and read just
     after, and every kernel of the path must launch in each (the cluster
     FPS in the seeding and the exact recombination);
  6. profile one more bf16 run of each recombination with torch.profiler:
     device time by kernel group and the device's idle share;
  7. training: hold the training kernels, K2b (voxelize backward) and the
     backward scatter of K3, K4 and K6 (scatter_rows) in bf16 and f32,
     torch.equal to their plain versions (scatter_rows run on the CPU), and
     K7 (auction EMD) on the distances of a real batch, at the training
     shapes (B = 32 patches of 2048 points), and time them; time K1's
     backward (cuDNN) with and without cuDNN's deterministic algorithms;
     hold the f32 gradient of the loss at full width on the card against
     the CPU's (B = 2, dropout off, fixed timesteps) and two card runs of
     it bit-equal; two bf16 forward + backward passes at the training
     shape (bs 32, dropout, the K7 alignment, generators reseeded) bit-equal
     in every parameter's gradient; log what one training step under
     torch.use_deterministic_algorithms(True, warn_only=True) warns; train
     PVDS_PUNet as shipped (bf16, AdamW, clip 1.0, EMA, the K7 alignment)
     for 31 steps through ``train`` on a synthetic PUNet tree written with
     numpy: every loss finite, the last five below the first five, the
     launch counts set to 0 just before step 20 and read just after with
     every training kernel launched, ms per step over steps 10-29 split
     into its phases, a torch.profiler profile of step 30; and a checkpoint
     that denoise_object.load_weights reads back into a model whose
     forward on the card is bit-equal to the trained model's.
The line before the last is a JSON object with each kernel's launches,
errors, times (back to back, device, host per call) and bounds; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import re
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
from p2p_bridge_tpu_torch.metrics.emd_auction import align_clean_to_noisy
from p2p_bridge_tpu_torch.models.model_loader import save_checkpoint
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.parallel.train_step import init_train_state, train_step
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
    "fps_cluster": ("p2p_bridge_tpu_torch/csrc/fps.cu",
                    "p2p_bridge_tpu/ops/pallas/fps_kernel.py:39"),
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
    # no Pallas kernel: the JAX package's backwards are XLA
    "scatter_rows": ("p2p_bridge_tpu_torch/csrc/scatter_rows.cu",
                     "p2p_bridge_tpu/ops/devoxelize.py:179 _devox_bwd and :274 "
                     "_devox_mean_bwd, ops/fused_group.py:47 _fused_tpu_bwd, "
                     "ops/interpolate.py:108 _nn_interp_fused_bwd (XLA, no Pallas kernel)"),
}
SERVING = ("fps", "ball_query_group", "avg_voxelize", "conv3d_gn", "trilinear_devoxelize",
           "three_nn_interpolate")  # the kernels of every denoising path's backbone
TRAINING = tuple(k for k in KERNELS if k != "fps_cluster")  # a training step's
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


def host_us(fn, ms: float) -> float:
    """Host time of one call of ``fn`` in microseconds: the host clock over
    a few hundred calls (fewer where ``ms``, the call's device time, would
    keep the card busy for more than 0.2 s) with no synchronise, i.e. what
    enqueueing the call costs. The device's queue is drained before and
    after."""
    calls = int(min(300, max(3, 200.0 / max(ms, 1e-6))))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def trace_events(prof) -> list:
    """The device-side events (kernels, copies, sets) of a finished
    torch.profiler run: [(name, start us, duration us)]."""
    with tempfile.TemporaryDirectory() as tmp:
        trace = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def device_ms(fn, kernel: str, calls: int = 10, attempts: int = 3) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    device functions of ``kernel`` (KERNEL_FUNCTIONS) in a torch.profiler
    trace of ``calls`` back-to-back calls, over ``calls``. A trace now and
    then comes back without any device events, so an empty one is taken
    again, up to ``attempts`` times in all; then this raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {}
        for name, _, dur in trace_events(prof):
            if kernel_group(name) == kernel:
                fn_name = re.search(r"\(anonymous namespace\)::(\w+)", name).group(1)
                split[fn_name] = split.get(fn_name, 0.0) + dur / 1e3 / calls
        if split:
            break
        log(f"  {kernel}: trace {attempt} of {attempts} holds none of its device functions")
    else:
        raise AssertionError(f"{attempts} traces of {kernel} hold none of its device functions")
    if len(split) > 1:
        log(f"  {kernel} device ms per call by function: "
            + ", ".join(f"{f} {ms:.4f}" for f, ms in split.items()))
    return sum(split.values())


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
        self.device_ms = 0.0  # profiled device time of the kernel's functions
        self.host_us = []  # (calls, host us per call) of each shape
        self.err = 0.0
        self.extra = {}  # further measurements for the kernels line

    def add(self, calls, ms, plain_ms, lib_ms, nbytes, ops, err, dev_ms=0.0, host=None):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[self.dtype] * 1e3
        self.ms += calls * ms
        self.device_ms += calls * dev_ms
        if host is not None and calls:
            self.host_us.append((calls, host))
        self.plain_ms += calls * plain_ms
        self.bytes_ms += calls * t_bytes
        self.ops_ms += calls * t_ops
        self.bound_ms += calls * max(t_bytes, t_ops)
        if self.library_ms is not None:
            self.library_ms = None if lib_ms is None else self.library_ms + calls * lib_ms
        self.err = max(self.err, err)
        return max(t_bytes, t_ops)

    def row(self) -> dict:
        calls = sum(c for c, _ in self.host_us)
        row = {"ms": self.ms, "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "bound_by": "bytes" if self.bytes_ms >= self.ops_ms else "operations",
               "library_ms": self.library_ms, "device_ms": self.device_ms,
               "host_us_per_call": sum(c * h for c, h in self.host_us) / max(calls, 1)}
        if self.single_call_ms is not None:
            row["single_call_ms"] = self.single_call_ms
        row.update(self.extra)
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
    kernels.entry_points()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {path}")


# ---------------------------------------------------------------- phase 3
def fps_equal(x, m, what, kernel=None) -> torch.Tensor:
    """The dispatched FPS (or ``kernel``, "fps" or "fps_cluster") on the
    card, torch.equal to the plain version on the card; returns its indices."""
    got = (fps_ops.furthest_point_sample(x, m) if kernel is None
           else fps_ops._fps_launch(kernel, x, m))
    want = fps_ops.furthest_point_sample_plain(x, m)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).nonzero()
        raise AssertionError(f"fps {what}: {bad.shape[0]} indices differ from the plain "
                             f"version, the first at [cloud, sample] {bad[0].tolist()}")
    return got


def tied_cloud(rng, n: int, chunk: int) -> np.ndarray:
    """n points in which every point appears twice, each copy at a random
    place (so every pick ties two indices), on a 1/64 grid (so distinct
    points tie too), and the last point of each cluster CTA's range
    repeated as the first of the next (ties across CTA boundaries)."""
    half = np.round(surface_cloud(rng, (n + 1) // 2) * 64) / 64
    x = np.concatenate([half, half])[rng.permutation(2 * len(half))][:n]
    for c in range(1, -(-n // chunk)):
        x[c * chunk] = x[c * chunk - 1]
    return x.astype(np.float32)


def fps_crossover(rng, dev) -> dict:
    """Both K5 kernels for growing N, 511 iterations each, at B = 1 and at
    B = 73 (the one-block kernel runs a block per cloud on 132 SMs, the
    cluster kernel a cluster per cloud, a few at a time): us per iteration
    of the whole batch, indices equal to each other and to the plain
    version. The crossover is the smallest N from which the cluster kernel
    is the faster at B = 1."""
    m, rows = 512, {}
    for b, sizes in ((1, (2048, 4096, 8192, 12288, 16384, 32768, 65536)),
                     (PATCHES, (4096, 16384, 32768))):
        for n in sizes:
            x = patches(rng, b, n, dev)
            t = {}
            for kernel in ("fps", "fps_cluster"):
                fps_equal(x, m, f"crossover {kernel} B={b} N={n}", kernel)
                t[kernel] = time_ms(lambda: fps_ops._fps_launch(kernel, x, m)) / (m - 1) * 1e3
            rows[f"B={b} N={n}"] = t
            log(f"fps crossover B={b} N={n} -> {m}: one block {t['fps']:.3f} us an iteration, "
                f"cluster {t['fps_cluster']:.3f} us")
    single = {int(k.split("N=")[1]): t for k, t in rows.items() if k.startswith("B=1 ")}
    crossover = next((n for n in sorted(single) if all(
        single[k]["fps_cluster"] < single[k]["fps"] for k in single if k >= n)), None)
    log(f"fps crossover: at B=1 the cluster kernel is the faster from N={crossover}; the "
        f"dispatch switches at N={fps_ops.CLUSTER_MIN_POINTS}")
    return {"us_per_iteration": rows, "crossover_n_b1": crossover,
            "dispatch_n": fps_ops.CLUSTER_MIN_POINTS}


def check_fps(rng, dev, shapes) -> dict:
    """K5 at the backbone's shapes (one block per cloud, "fps") and at the
    exact recombination's and the seeding's (one cluster per cloud,
    "fps_cluster"); indices torch.equal to the plain version everywhere."""
    exact_n = PATCHES * PATCH
    # (what, clouds, points, samples, calls on the path, timed runs)
    cases = [(f"sa{i} centres", PATCHES, n, m, 1, RUNS)
             for i, (n, m, _, _, _) in enumerate(shapes["sa"])]
    cases += [("bucketed recombination", PATCHES, PATCH, 685, 0, RUNS),
              ("seeding", 1, 50_000, PATCHES, 1, RUNS),
              ("exact recombination", 1, exact_n, 50_000, 1, RUNS)]
    tallies = {"fps": Tally("f32", library=False), "fps_cluster": Tally("f32", library=False)}
    extra = {}
    for what, b, n, m, calls, runs in cases:
        kernel = "fps_cluster" if n >= fps_ops.CLUSTER_MIN_POINTS else "fps"
        x = patches(rng, b, n, dev)
        fps_equal(x, m, what)
        ms = time_ms(lambda: fps_ops.furthest_point_sample(x, m), runs)
        dms = device_ms(lambda: fps_ops.furthest_point_sample(x, m), kernel)
        hus = host_us(lambda: fps_ops.furthest_point_sample(x, m), ms)
        plain = time_ms(lambda: fps_ops.furthest_point_sample_plain(x, m), 1)
        # per iteration and point: 3 sub, 3 mul, 2 add, min, compare
        bound = tallies[kernel].add(calls, ms, plain, None, b * n * 12 + b * m * 4,
                                    10.0 * b * (m - 1) * n, 0.0, dms, hus)
        log(f"{kernel} {what} [{b}, {n}] -> {m}: indices equal; kernel {ms:.3f} ms (device "
            f"{dms:.4f} ms, {dms / max(m - 1, 1) * 1e3:.3f} us an iteration; host {hus:.1f} us "
            f"a call), plain {plain:.3f} ms, bound {bound:.3g} ms")
        if what == "exact recombination":
            # the one-block kernel at the same shape, as before the cluster kernel
            one = time_ms(lambda: fps_ops._fps_launch("fps", x, m), 1)
            extra = {"exact_recombination_ms": ms, "exact_recombination_device_ms": dms,
                     "exact_us_per_iteration": dms / (m - 1) * 1e3, "one_block_kernel_ms": one}
            log(f"fps exact recombination on the one-block kernel: {one:.1f} ms; the cluster "
                f"kernel {ms:.2f} ms ({one / ms:.1f}x)")
    # the bench's four objects, and a ragged cloud whose every pick is a tie
    x = patches(rng, 4, exact_n, dev)
    fps_equal(x, 50_000, f"[4, {exact_n}]")
    ms4 = time_ms(lambda: fps_ops.furthest_point_sample(x, 50_000), 2)
    log(f"fps_cluster [4, {exact_n}] -> 50000: indices equal; kernel {ms4:.2f} ms")
    n = 100_003
    x = torch.from_numpy(tied_cloud(rng, n, -(-n // 16))).to(dev)[None]
    fps_equal(x, 33_000, f"ragged tied [1, {n}]")
    log(f"fps_cluster ragged [1, {n}] -> 33000, every pick a tie, ties across the 16 CTAs' "
        "ranges: indices equal")
    # past the registers (N above 163,840): distances in a global scratch row
    x = patches(rng, 1, 200_000, dev)
    fps_equal(x, 3000, "[1, 200000], points past the registers")
    log("fps_cluster [1, 200000] -> 3000 (2,260 points a CTA past the registers): indices equal")
    extra.update(four_clouds_ms=ms4, crossover=fps_crossover(rng, dev))
    tallies["fps_cluster"].extra = extra
    return {name: {"f32": t} for name, t in tallies.items()}


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
            dms = device_ms(lambda: bq_ops.ball_query_group(centers, pts, rows, radius, k),
                            "ball_query_group")
            hus = host_us(lambda: bq_ops.ball_query_group(centers, pts, rows, radius, k), ms)
            plain = time_ms(lambda: bq_ops.ball_query_group_plain(centers, pts, rows, radius, k))
            # the scan stops at the warp of the K-th hit: count what it reads
            hits = (pairwise_sqdist_exact(centers, pts) < bq_ops._radius_sq(radius)).cumsum(-1)
            kth = torch.where(hits[..., -1] >= k, (hits < k).sum(-1), torch.full_like(hits[..., -1], n))
            scanned = torch.clamp((kth // 32 + 1) * 32, max=n).sum().item()
            nbytes = (PATCHES * (m + n) * 12 + PATCHES * n * c * esize(dt)
                      + PATCHES * m * k * (c * esize(dt) + 4))
            bound = tally.add(1, ms, plain, None, nbytes, 8.0 * scanned, 0.0, dms, hus)
            log(f"ball_query_group {name} {n}->{m} r={radius} C={c}: idx and rows equal; "
                f"kernel {ms:.3f} ms (device {dms:.4f} ms, host {hus:.1f} us a call), "
                f"plain {plain:.3f} ms, bound {bound:.3g} ms")
            del hits
        out[name] = tally
    return out


# PVDL_SNPP's ragged (C = 67) and widest voxelize calls, checked at B = 4
SNPP_VOXELIZE = ((4096, 32, 67), (64, 8, 512))


def voxelize_equal(rng, dev, dt, b, n, r, c):
    """K2 on the card against the plain version on the CPU from the same
    inputs, grid and counts torch.equal, and against a second kernel call;
    the op the model calls returns the same grid. Returns the inputs."""
    what = f"avg_voxelize {dt} B={b} N={n} r={r} C={c}"
    pts = patches(rng, b, n, dev)
    vox, _ = vox_ops.normalize_coords_to_voxels(pts, r)
    feat = torch.randn(b, n, c, device=dev).to(dt)
    got, cnt = vox_ops._avg_voxelize_cuda(feat, vox, r)
    again, cnt_again = vox_ops._avg_voxelize_cuda(feat, vox, r)
    model_op = vox_ops.avg_voxelize(feat, vox, r)
    want, want_cnt = vox_ops._avg_voxelize_plain(feat.cpu(), vox.cpu(), r)
    if not (got.dtype == dt and torch.equal(cnt.cpu(), want_cnt)):
        raise AssertionError(f"{what}: counts differ from the CPU plain version")
    if not torch.equal(got.cpu(), want):
        bad = (got.cpu() != want).sum().item()
        err = (got.cpu().float() - want.float()).abs().max().item()
        raise AssertionError(f"{what}: {bad} grid values differ from the CPU plain "
                             f"version, by up to {err}")
    if not (torch.equal(got, again) and torch.equal(cnt, cnt_again)):
        raise AssertionError(f"{what}: two kernel calls differ")
    if not torch.equal(model_op.reshape(got.shape), got):
        raise AssertionError(f"{what}: avg_voxelize differs from the kernel's grid")
    return feat, vox


def check_voxelize(rng, dev, shapes) -> dict:
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=True)
        for (n, r, c), calls in counted((n, r, cin) for n, r, cin, _ in shapes["pvconv"]):
            feat, vox = voxelize_equal(rng, dev, dt, PATCHES, n, r, c)
            ms = time_ms(lambda: vox_ops.avg_voxelize(feat, vox, r))
            dms = device_ms(lambda: vox_ops.avg_voxelize(feat, vox, r), "avg_voxelize")
            hus = host_us(lambda: vox_ops.avg_voxelize(feat, vox, r), ms)
            plain = time_ms(lambda: vox_ops.avg_voxelize_plain(feat, vox, r))
            idx = vox_ops.flat_voxel_index(vox, r).long()[..., None].expand(PATCHES, n, c)
            grid = torch.zeros(PATCHES, r ** 3, c, device=dev, dtype=dt)
            lib = time_ms(lambda: grid.scatter_reduce_(1, idx, feat, "mean", include_self=False))
            # features and coordinates read once; grid and counts written once
            nbytes = PATCHES * n * (c * esize(dt) + 12) + PATCHES * r ** 3 * (c * esize(dt) + 4)
            bound = tally.add(calls, ms, plain, lib, nbytes,
                              PATCHES * (n + r ** 3) * c, 0.0, dms, hus)
            log(f"avg_voxelize {name} N={n} r={r} C={c} x{calls}: grid and counts equal to "
                f"the CPU plain version, two calls equal; kernel {ms:.3f} ms (device {dms:.4f} "
                f"ms, host {hus:.1f} us a call), plain {plain:.3f} ms, scatter_reduce_ "
                f"{lib:.3f} ms, bound {bound:.3g} ms")
            del grid, idx
        for n, r, c in SNPP_VOXELIZE:
            voxelize_equal(rng, dev, dt, 4, n, r, c)
            log(f"avg_voxelize {name} PVDL_SNPP N={n} r={r} C={c} B=4: grid and counts equal "
                "to the CPU plain version, two calls equal")
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
            dms = device_ms(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act),
                            "conv3d_gn")
            hus = host_us(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act), ms)
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
            bound = tally.add(calls, ms, plain, lib, nbytes, flop, err, dms, hus)
            log(f"conv3d_gn {name} r={r} {cin}->{cout} x{calls} B={PATCHES}: max err {err:.3g} "
                f"(tol {tol:.3g}); kernel {ms:.3f} ms (device {dms:.4f} ms, host {hus:.1f} us "
                f"a call; {flop / ms / 1e9:.2f} TFLOP/s, "
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
            dms = device_ms(lambda: devox_ops.trilinear_devoxelize_with_mean(grid, cont, r),
                            "trilinear_devoxelize")
            hus = host_us(lambda: devox_ops.trilinear_devoxelize_with_mean(grid, cont, r), ms)
            plain = time_ms(lambda: (devox_ops.trilinear_devoxelize_plain(grid, cont, r),
                                     devox_ops.grid_mean_plain(grid)))
            # F.grid_sample on [B, C, D, H, W] at (x, y, z) = (k, j, i) in [-1, 1]
            gc = grid.permute(0, 4, 1, 2, 3).contiguous()
            loc = (cont.flip(-1) / (r - 1) * 2 - 1).to(dt).view(PATCHES, 1, 1, n, 3)
            lib = time_ms(lambda: F.grid_sample(gc, loc, mode="bilinear", align_corners=True))
            nbytes = (PATCHES * r ** 3 * c * esize(dt) + PATCHES * n * 12
                      + PATCHES * n * c * esize(dt) + PATCHES * c * 4)
            ops = PATCHES * n * (8 * 2 * c + 24) + PATCHES * r ** 3 * c
            bound = tally.add(calls, ms, plain, lib, nbytes, ops, err, dms, hus)
            log(f"trilinear_devoxelize {name} N={n} r={r} C={c} x{calls}: max err {err:.3g} "
                f"(tol {tol:.3g}); kernel {ms:.3f} ms (device {dms:.4f} ms, host {hus:.1f} us "
                f"a call), plain {plain:.3f} ms, "
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
            dms = device_ms(lambda: interp_ops.nearest_neighbor_interpolate(pts, centers, feat),
                            "three_nn_interpolate")
            hus = host_us(lambda: interp_ops.nearest_neighbor_interpolate(pts, centers, feat), ms)
            plain = time_ms(lambda: interp_ops.three_nn_interpolate_plain(pts, centers, feat))
            nbytes = PATCHES * (n + m) * 12 + PATCHES * (m + n) * c * esize(dt)
            # per (point, centre) pair: 3 sub, 3 mul, 2 add
            bound = tally.add(1, ms, plain, None, nbytes, 8.0 * PATCHES * n * m, err, dms, hus)
            log(f"three_nn_interpolate {name} {n}<-{m} C={c}: indices equal, weights {err_w:.3g}, "
                f"max err {err:.3g} (tol {tol:.3g}); kernel {ms:.3f} ms (device {dms:.4f} ms, "
                f"host {hus:.1f} us a call), plain {plain:.3f} ms, "
                f"bound {bound:.3g} ms")
        out[name] = tally
    return out


def check_kernels(dev, plan) -> dict:
    rng = np.random.default_rng(0)
    shapes = main_path_shapes(plan, PATCH)
    log(f"main path shapes at B={PATCHES}: {json.dumps(shapes)}")
    results = {
        **check_fps(rng, dev, shapes),
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


def launch_path_costs(dev) -> dict:
    """Host microseconds per call (host_us) of K2b's wrapper at the
    training step's r = 32 shape, of the same call through the earlier
    launch path (a generic check per tensor, torch.empty, a
    torch.cuda.device context and a Stream object for the raw handle),
    of the launch alone, and of each piece of both paths."""
    B, N, r, C = TRAIN_B, PATCH, 32, 35
    g = torch.randn(B, r ** 3, C, device=dev).bfloat16()
    idx = torch.randint(0, r ** 3, (B, N), device=dev, dtype=torch.int32)
    cnt = torch.ones(B, r ** 3, device=dev)
    out = torch.empty(B, N, C, device=dev, dtype=torch.bfloat16)
    index = dev.index
    args = (g.data_ptr(), idx.data_ptr(), cnt.data_ptr(), B, N, r ** 3, C, 1, out.data_ptr())
    entry = kernels.entry_points()["p2pb_avg_voxelize_backward"]
    stream = kernels.current_stream(index)

    def generic_check(t, dtype, shape):  # one tensor, as the earlier launch path did
        if t.device != dev or t.dtype != dtype or t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)) or not t.is_contiguous():
            raise ValueError("bad tensor")

    def device_context():
        with torch.cuda.device(dev):
            pass

    def earlier_wrapper():  # K2b's wrapper as the earlier launch path built it
        kernels.on_card(g)
        generic_check(g, torch.bfloat16, (B, r ** 3, C))
        generic_check(idx, torch.int32, (B, N))
        generic_check(cnt, torch.float32, (B, r ** 3))
        res = torch.empty((B, N, C), dtype=torch.bfloat16, device=dev)
        with torch.cuda.device(dev):
            err = entry(g.data_ptr(), idx.data_ptr(), cnt.data_ptr(), B, N, r ** 3, C, 1,
                        res.data_ptr(), index, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"K2b: CUDA error {err}")
        return res

    pieces = {
        "K2b wrapper (avg_voxelize_backward)": lambda: vox_ops.avg_voxelize_backward(g, idx, cnt),
        "K2b through the earlier launch path, rebuilt from its pieces": earlier_wrapper,
        "kernels.launch": lambda: kernels.launch("avg_voxelize_backward",
                                                 "p2pb_avg_voxelize_backward", index, *args),
        "ctypes call of the entry (launches K2b)": lambda: entry(*args, index, stream),
        "kernels.check of 3 tensors": lambda: kernels.check(
            ("grad", g, kernels.DATA, (B, r ** 3, C)), ("idx", idx, torch.int32, (B, N)),
            ("cnt", cnt, torch.float32, (B, r ** 3))),
        "3 generic checks (earlier path)": lambda: (
            generic_check(g, torch.bfloat16, (B, None, C)), generic_check(idx, torch.int32, (B, N)),
            generic_check(cnt, torch.float32, (B, r ** 3))),
        "kernels.current_stream": lambda: kernels.current_stream(index),
        "torch.cuda.current_stream(dev).cuda_stream (earlier path)":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "with torch.cuda.device(dev) (earlier path)": device_context,
        "torch.empty(shape, dtype=, device=)":
            lambda: torch.empty((B, N, C), dtype=torch.bfloat16, device=dev),
        "t.new_empty(shape)": lambda: g.new_empty((B, N, C)),
        "t.new_empty(shape, dtype=)": lambda: g.new_empty((B, N), dtype=torch.int32),
    }
    costs = {}
    for name, fn in pieces.items():
        costs[name] = float(np.median([host_us(fn, 0.0) for _ in range(3)]))
        log(f"launch path, host us per call: {costs[name]:.2f}  {name}")
    return costs


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


def output_fingerprints(model, x, t) -> list:
    """[(module name, bit sum of its output)] of one forward, in the order
    the modules finish: where two runs part, the first differing entry
    names the module whose output varied first."""
    prints, hooks = [], []

    def hook(name, _mod, _inp, out):
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if torch.is_tensor(o) and o.is_floating_point():
                bits = o.detach().contiguous().view(torch.uint8)
                prints.append((name, torch.sum(bits, dtype=torch.int64).item()))

    for name, mod in model.named_modules():
        hooks.append(mod.register_forward_hook(lambda *a, name=name: hook(name, *a)))
    try:
        with torch.no_grad():
            model(x, t)
    finally:
        for h in hooks:
            h.remove()
    return prints


def check_determinism(model, dev) -> dict:
    """Two full-width bf16 forwards (B = 73 patches) of the same weights and
    inputs must be bit-equal; where they are not, the error names the first
    module whose output differs between two traced runs."""
    rng = np.random.default_rng(5)
    x = patches(rng, PATCHES, PATCH, dev)
    t = torch.from_numpy(rng.uniform(0.0, 1000.0, PATCHES).astype(np.float32)).to(dev)
    with torch.no_grad():
        first = model(x, t)
        second = model(x, t)
    if not torch.equal(first, second):
        a, b = output_fingerprints(model, x, t), output_fingerprints(model, x, t)
        where = next((na for (na, fa), (_, fb) in zip(a, b) if fa != fb), "no module output")
        raise AssertionError(f"two bf16 forwards at B={PATCHES} differ by up to "
                             f"{(first.float() - second.float()).abs().max().item()}; first "
                             f"differing module output: {where}")
    log(f"two bf16 forwards of PVDS_PUNet at B={PATCHES} x {PATCH}, same weights and "
        "inputs: bit-equal")
    return {"bit_equal": True, "patches": PATCHES}


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
            # the seeding (50,000 points) and the exact recombination (149,504)
            # take the cluster kernel from CLUSTER_MIN_POINTS points a cloud
            need = SERVING + (("fps_cluster",) if mode == "exact"
                              or 50_000 >= fps_ops.CLUSTER_MIN_POINTS else ())
            idle = [k for k in need if launches.get(k, 0) == 0]
            if idle:
                raise AssertionError(f"kernels not launched on the {name} {mode} path: {idle}")
            runs[name][mode] = {"ms": ms, "launches": launches}
    return runs


# ---------------------------------------------------------------- phase 6
# device kernels of each hand-written kernel, by function name
KERNEL_FUNCTIONS = {
    "conv3d_gn": ("conv_tile_kernel", "conv_wgmma_kernel", "gn_stats_kernel", "gn_apply_kernel",
                  "gn_apply_bf16_kernel"),
    "avg_voxelize": ("bucket_kernel", "rows_kernel"),
    "trilinear_devoxelize": ("devox_kernel", "mean_partial_kernel", "mean_final_kernel"),
    "ball_query_group": ("ball_query_group_kernel",),
    "fps": ("fps_kernel",),
    "fps_cluster": ("fps_cluster_kernel",),
    "three_nn_interpolate": ("three_nn_interp_kernel",),
    "avg_voxelize_backward": ("gather_divide_kernel",),
    "auction_emd": ("auction_kernel",),
    "scatter_rows": ("scatter_sort_kernel", "scatter_rows_kernel"),
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


def profile_bf16(model, dev, mode: str) -> dict:
    """torch.profiler over one bf16 50k run with ``mode`` recombination:
    device time by kernel group and the idle share (1 - union of
    kernel/copy/set intervals / host wall time of the traced call)."""
    from torch.profiler import ProfilerActivity, profile

    bridge = P2PBridge.from_config(pvds_punet(), model)
    pcl = cloud_50k()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        denoise(bridge, pcl, mode, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_time(prof, wall_ms, f"bf16 {mode}")


def device_time(prof, wall_ms: float, what: str) -> dict:
    """Device time by kernel group of a finished torch.profiler run and the
    idle share: 1 - union of kernel/copy/set intervals / host wall time."""
    spans, groups = [], {}
    for name, ts, dur in trace_events(prof):
        spans.append((ts, ts + dur))
        total, calls = groups.get(kernel_group(name), (0.0, 0))
        groups[kernel_group(name)] = (total + dur / 1e3, calls + 1)
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
            dms = device_ms(lambda: vox_ops.avg_voxelize_backward(g, idx, cnt),
                            "avg_voxelize_backward")
            hus = host_us(lambda: vox_ops.avg_voxelize_backward(g, idx, cnt), ms)
            plain = time_ms(lambda: vox_ops.avg_voxelize_backward_plain(g, idx, cnt))
            # library: torch.gather of the rows, then the divide (two calls)
            rows_idx = idx.long()[..., None].expand(TRAIN_B, n, c)
            den = torch.gather(cnt, 1, idx.long()).clamp_min(1.0)[..., None]
            lib = time_ms(lambda: torch.gather(g, 1, rows_idx) / den)
            lib_hus = host_us(lambda: torch.gather(g, 1, rows_idx) / den, lib)
            touched = torch.unique(idx.long() + torch.arange(TRAIN_B, device=dev)[:, None] * r ** 3)
            nbytes = (touched.numel() * (c * esize(dt) + 4) + TRAIN_B * n * 4
                      + TRAIN_B * n * c * esize(dt))
            bound = tally.add(calls, ms, plain, lib, nbytes, TRAIN_B * n * c, 0.0, dms, hus)
            log(f"avg_voxelize_backward {name} N={n} r={r} C={c} x{calls} B={TRAIN_B}: "
                f"bit-equal; kernel {ms:.4f} ms (device {dms:.4f} ms, host {hus:.1f} us a "
                f"call), plain {plain:.4f} ms, gather + divide (2 calls) {lib:.4f} ms "
                f"(host {lib_hus:.1f} us), bound {bound:.4g} ms")
        out[name] = tally
    return out


def scatter_cases(rng, dev, dt, shapes):
    """The backward scatters of one training step at B = TRAIN_B, from the
    forwards' own indices and weights: [(what, calls, kernel wrapper, plain
    version, their arguments, rows a cloud, (flat destination rows, f32
    terms) of the one index_add_ that computes the same, bytes,
    operations)]."""
    B, cases = TRAIN_B, []
    for (n, r, c), calls in counted((n, r, cout) for n, r, _, cout in shapes["pvconv"]):
        _, cont = vox_ops.normalize_coords_to_voxels(patches(rng, B, n, dev), r)
        g = torch.randn(B, n, c, device=dev).to(dt)
        base = (torch.arange(B, device=dev) * r ** 3)[:, None]
        parts = [((idx + base).reshape(-1), ((wx * wy)[..., None] * (wz[..., None] * g.float()))
                  .reshape(-1, c)) for idx, wx, wy, wz in devox_ops._corners(cont, r)]
        cases.append((f"K3 devoxelize N={n} r={r} C={c}", calls,
                      devox_ops._devoxelize_backward_cuda,
                      lambda g, cont, r: devox_ops.trilinear_devoxelize_backward(
                          g, cont, r).to(g.dtype), (g, cont, r), r ** 3,
                      (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])),
                      B * n * (c * esize(dt) + 12) + B * r ** 3 * c * esize(dt),
                      B * 8 * n * (4 * c + 12)))
    for n, m, radius, k, c in shapes["sa"]:
        pts = patches(rng, B, n, dev)
        rows = torch.randn(B, n, c, device=dev).to(dt)
        _, idx = bq_ops.ball_query_group(pts[:, :m].contiguous(), pts, rows, radius, k)
        g = torch.randn(B, m, k, c, device=dev).to(dt)
        base = (torch.arange(B, device=dev) * n)[:, None, None]
        cases.append((f"K4 ball_query_group {n}->{m} K={k} C={c}", 1,
                      bq_ops._ball_query_group_backward_cuda,
                      lambda g, idx, n: bq_ops.ball_query_group_backward(g, idx, n).to(g.dtype),
                      (g, idx, n), n, ((idx.long() + base).reshape(-1), g.float().reshape(-1, c)),
                      B * m * k * (c * esize(dt) + 4) + B * n * c * esize(dt), B * m * k * c))
    for n, m, c in shapes["fp"]:
        pts = patches(rng, B, n, dev)
        _, w, idx = interp_ops.three_nn_interpolate(
            pts, pts[:, :m].contiguous(), torch.randn(B, m, c, device=dev).to(dt))
        g = torch.randn(B, n, c, device=dev).to(dt)
        base = (torch.arange(B, device=dev) * m)[:, None, None]
        cases.append((f"K6 three_nn_interpolate {n}<-{m} C={c}", 1,
                      interp_ops._three_nn_interpolate_backward_cuda,
                      lambda g, w, idx, m: interp_ops.three_nn_interpolate_backward(
                          g, w, idx, m).to(g.dtype), (g, w, idx, m), m,
                      ((idx.long() + base).reshape(-1),
                       (w[..., None] * g.float()[:, :, None, :]).reshape(-1, c)),
                      B * n * (c * esize(dt) + 24) + B * m * c * esize(dt), B * 3 * n * 2 * c))
    return cases


def check_scatter(rng, dev, shapes) -> dict:
    """Kernel scatter_rows at every backward scatter of the training step
    (B = 32), bf16 and f32: torch.equal to the plain version run on the CPU
    from the same inputs and to a second call; timed beside the plain
    version on the card (index_add_) and one index_add_ of the precomputed
    terms."""
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=True)
        for what, calls, kernel, plain_fn, args, rows, (flat, src), nbytes, ops in scatter_cases(
                rng, dev, dt, shapes):
            got, again = kernel(*args), kernel(*args)
            want = plain_fn(*(a.cpu() if torch.is_tensor(a) else a for a in args))
            torch.cuda.synchronize()
            if not (got.dtype == dt and torch.equal(got.cpu(), want)):
                bad = (got.cpu() != want).sum().item()
                err = (got.cpu().float() - want.float()).abs().max().item()
                raise AssertionError(f"scatter_rows {name} {what}: {bad} values differ from the "
                                     f"CPU plain version, by up to {err}")
            if not torch.equal(got, again):
                raise AssertionError(f"scatter_rows {name} {what}: two kernel calls differ")
            ms = time_ms(lambda: kernel(*args))
            dms = device_ms(lambda: kernel(*args), "scatter_rows")
            hus = host_us(lambda: kernel(*args), ms)
            plain = time_ms(lambda: plain_fn(*args))
            acc = torch.zeros(TRAIN_B * rows, src.shape[-1], device=dev)
            lib = time_ms(lambda: acc.index_add_(0, flat, src))
            bound = tally.add(calls, ms, plain, lib, nbytes, ops, 0.0, dms, hus)
            log(f"scatter_rows {name} {what} x{calls} B={TRAIN_B}: bit-equal to the CPU plain "
                f"version, two calls equal; kernel {ms:.4f} ms (device {dms:.4f} ms, host "
                f"{hus:.1f} us a call), plain (index_add_) {plain:.4f} ms, one index_add_ of "
                f"the terms {lib:.4f} ms, bound {bound:.4g} ms")
            del flat, src, acc
        out[name] = tally
    return out


def cudnn_backward_cost(dev, shapes) -> dict:
    """K1's backward (the recomputed conv + GroupNorm and its gradient
    through cuDNN) at the training step's 16 convs (B = 32, bf16), with
    cuDNN's deterministic algorithms as the port runs it and without them,
    TF32 off in both: ms per step, and the deterministic gradient's bits
    equal over two calls."""
    convs = []
    for _, r, cin, cout in shapes["pvconv"]:
        convs += [(r, cin, cout, True), (r, cout, cout, False)]
    gen = torch.Generator(device=dev).manual_seed(7)
    total = {True: 0.0, False: 0.0}
    for (r, cin, cout, act), calls in counted(convs):
        x, w, b, gamma, beta = conv_inputs(gen, dev, torch.bfloat16, TRAIN_B, r, cin, cout, False)
        inputs = [t.requires_grad_() for t in (x, w, b, gamma, beta)]
        g = torch.randn(TRAIN_B, r, r, r, cout, device=dev, generator=gen).bfloat16()

        def backward(det, inputs=inputs, g=g, act=act):
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=det,
                                            allow_tf32=False):
                y = conv_ops.conv3d_gn_reference(*inputs, 8, 1e-5, act)
                return torch.autograd.grad(y, inputs, g)

        first, second = backward(True), backward(True)
        if not all(torch.equal(a, c) for a, c in zip(first, second)):
            raise AssertionError(f"K1 backward r={r} {cin}->{cout}: two deterministic calls differ")
        ms = {det: time_ms(lambda det=det: backward(det)) for det in (True, False)}
        for det in ms:
            total[det] += calls * ms[det]
        log(f"K1 backward (cuDNN) bf16 r={r} {cin}->{cout} x{calls} B={TRAIN_B}: deterministic "
            f"{ms[True]:.3f} ms (two calls bit-equal), default algorithms {ms[False]:.3f} ms")
        del x, inputs, g
        torch.cuda.empty_cache()
    log(f"K1 backward per training step: deterministic {total[True]:.2f} ms, default "
        f"{total[False]:.2f} ms")
    return {"deterministic_ms": total[True], "default_ms": total[False]}


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
            dms = device_ms(lambda: emd_auction.auction_emd_assign(d2, 0.01, iters),
                            "auction_emd")
            hus = host_us(lambda: emd_auction.auction_emd_assign(d2, 0.01, iters), ms)
            plain = time_ms(lambda: emd_auction.auction_emd_plain(d2, 0.01, iters), runs=2)
            # d2 read once, outputs written once; per scanned element a
            # subtract, a compare and a max
            nbytes = B * N * M * 4 + B * N * 8
            bound = tally.add(1, ms, plain, None, nbytes, 3.0 * (rows + left) * M, 0.0, dms, hus)
            log(f"auction_emd kernel {ms:.3f} ms (device {dms:.4f} ms, host {hus:.1f} us a "
                f"call), plain {plain:.3f} ms, bound {bound:.4g} ms "
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
    for _ in range(2):  # twice: the card must give the same bits
        card.zero_grad(set_to_none=True)
        got = P2PBridge.from_config(cfg, card).loss_fn(x0.to(dev), x1.to(dev),
                                                       steps=steps.to(dev))
        got.backward()
        runs.append([p.grad.cpu() for p in card.parameters()])
    again = (sum((a - b).norm() ** 2 for a, b in zip(*runs)) ** 0.5
             / sum(b.norm() ** 2 for b in runs[1]) ** 0.5).item()
    differ = first_differing(card, *runs)
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
        f"{'bit-equal' if differ is None else f'differ first in {differ}'}, relative L2 "
        f"{again:.3g}")
    if not (math.isfinite(got.item()) and loss_err <= LOSS_REL and total <= GRAD_REL_L2
            and worst <= PARAM_REL_L2):
        raise AssertionError(f"card gradient differs from the CPU: loss {loss_err}, whole "
                             f"{total}, {worst_name} {worst}")
    if differ is not None:
        raise AssertionError(f"two card runs of the f32 gradient (B=2) differ, first in "
                             f"{differ}; whole gradient relative L2 {again}")
    return {"loss_rel": loss_err, "grad_rel_l2": total, "worst_param": worst_name,
            "worst_param_rel_l2": worst, "card_vs_card_rel_l2": again, "card_runs_bit_equal": True}


def first_differing(model, first: list, second: list):
    """The name of the first parameter whose gradients in two runs are not
    torch.equal, or None."""
    return next((name for (name, _), a, b in zip(model.named_parameters(), first, second)
                 if not torch.equal(a, b)), None)


def train_gradient(model, bridge, batch: dict) -> torch.Tensor:
    """One forward + backward of a training step as train_step runs it:
    the K7 alignment, then the loss with its timesteps and noise from a
    generator seeded here and dropout from the CUDA RNG, seeded here too."""
    generator = torch.Generator(batch["x_start"].device).manual_seed(11)
    torch.cuda.manual_seed(12)
    x_gt = align_clean_to_noisy(batch["x_start"], batch["x_gt"], eps=0.01, iters=100)
    loss = bridge.loss_fn(x_gt, batch["x_start"], generator=generator)
    loss.backward()
    return loss


def check_train_gradient_bits(cfg: dict, batch: dict, dev) -> dict:
    """PVDS_PUNet as shipped (bf16, bs 32 x 2048, dropout, the K7
    alignment): one forward + backward twice from the same weights and
    batch, every generator reseeded before each; every parameter's gradient
    must be torch.equal, and the error names the first that differs."""
    model = build_unet_from_config(cfg).train()
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(dev)
    bridge = P2PBridge.from_config(cfg, model)
    runs, losses = [], []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        losses.append(train_gradient(model, bridge, batch).item())
        runs.append([p.grad.clone() for p in model.parameters()])
    differ = first_differing(model, *runs)
    log(f"bf16 forward + backward at the training shape (bs {TRAIN_B} x {PATCH}, dropout "
        f"{cfg['model']['dropout']}, K7 alignment), twice from the same weights and batch: "
        f"losses {losses}; gradients "
        f"{'bit-equal in every parameter' if differ is None else f'differ first in {differ}'}")
    if differ is not None or losses[0] != losses[1]:
        raise AssertionError(f"two bf16 training-shape gradients differ, first in {differ}; "
                             f"losses {losses}")
    return {"bit_equal": True, "loss": losses[0], "batch": TRAIN_B}


def determinism_audit(cfg: dict, batch: dict, dev) -> list:
    """One training step (alignment, forward + backward, clip, AdamW, EMA)
    under torch.use_deterministic_algorithms(True, warn_only=True): every
    distinct warning it gives, logged. A diagnostic only: the port's path
    sets no such flag."""
    import warnings

    model = build_unet_from_config(cfg).train()
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(dev)
    state = init_train_state(model, cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            train_step(P2PBridge.from_config(cfg, model), state, batch,
                       torch.Generator(dev).manual_seed(0), grad_clip=1.0,
                       align_cfg={"eps": 0.01, "iters": 100})
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    messages = sorted({f"{w.category.__name__}: {w.message}" for w in caught})
    for m in messages:
        log(f"determinism audit: {m}")
    log(f"determinism audit: {len(messages)} distinct warnings in one training step")
    return messages


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
    idle = [k for k in TRAINING if obs.launches.get(k, 0) == 0]
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


def check_checkpoint(state, cfg: dict, batch: dict, dev) -> dict:
    """save_checkpoint -> denoise_object.load_weights into fresh models,
    with and without --use_ema: every tensor equal to the trained one, and
    a bit-equal forward on one cloud, on the card."""
    x = batch["x_start"][:1]
    t = torch.tensor([700.0], device=dev)
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
            ref.to(dev)
            fresh.to(dev)
            with torch.no_grad():
                got, want = fresh(x, t), ref(x, t)
            if not (same and torch.equal(got, want)):
                raise AssertionError(f"checkpoint round trip (use_ema={use_ema}): weights equal "
                                     f"{same}, forward differs by {(got - want).abs().max()}")
    log("checkpoint round trip: save_checkpoint -> denoise_object.load_weights, with and "
        "without --use_ema: weights equal, forwards bit-equal (card, 1 x 2048)")
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
            np.random.default_rng(4), dev, shapes), "auction_emd": check_auction(batch, dev),
            "scatter_rows": check_scatter(np.random.default_rng(6), dev, shapes)}
        cudnn = cudnn_backward_cost(dev, shapes)
        gradient = check_gradient(dev)
        gradient["train_shape"] = check_train_gradient_bits(cfg, batch, dev)
        audit = determinism_audit(cfg, batch, dev)
        torch.cuda.empty_cache()
        state, run = train_phase(cfg, dev)
        checkpoint = check_checkpoint(state, cfg, batch, dev)
    return {"results": results, "gradient": gradient, "run": run, "checkpoint": checkpoint,
            "k1_backward_cudnn": cudnn, "determinism_audit": audit}


def main() -> None:
    require_card()
    dev = torch.device("cuda", 0)
    build_kernels()
    with torch.device("meta"):
        plan = build_unet_from_config(pvds_punet()).plan
    results = check_kernels(dev, plan)
    launch_costs = launch_path_costs(dev)
    model, twin = build_models(dev)
    forward = check_forward(model, twin, dev)
    forward["determinism"] = check_determinism(model, dev)
    run = denoise_50k(model, twin, dev)
    profile = {mode: profile_bf16(model, dev, mode) for mode in ("bucketed", "exact")}
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
        path, timed = {
            "fps_cluster": (f"{MAIN} exact", "kernel calls of one 50k denoise with exact "
                            "recombination: the seeding and the recombination"),
        }.get(name, (f"{MAIN} bucketed", f"kernel calls of one PVDS_PUNet forward at B={PATCHES}")
              if name in SERVING else
              ("bf16 train step", f"kernel calls of one PVDS_PUNet training step at B={TRAIN_B}"))
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": by_path[path], "launches_by_path": by_path,
                 "max_abs_err": max(t.err for t in per_dtype.values()),
                 **per_dtype[dtype].row(), "dtype": dtype,
                 "max_abs_err_by_dtype": {d: t.err for d, t in per_dtype.items()},
                 "f32": per_dtype["f32"].row(), "timed": timed}
        entries.append(entry)
    line = {"kernels": entries, "forward": forward, "launch_path_host_us": launch_costs,
            "denoise_50k_ms": {f"{d} {m}": r["ms"] for d, modes in run.items()
                               for m, r in modes.items()},
            "profile_bf16": profile,
            "train": {"gradient": trained["gradient"], "checkpoint": trained["checkpoint"],
                      "k1_backward_cudnn": trained["k1_backward_cudnn"],
                      "determinism_audit": trained["determinism_audit"],
                      **{k: v for k, v in trained["run"].items() if k != "launches"}}}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
