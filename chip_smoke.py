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
     and the bucketed recombination (one warp or block per cloud), also on
     clouds whose every pick ties across lanes and warps and at odd N (33,
     1000, 4097, 16,383) and [8, 4096], and at the seeding, the exact
     recombination [1 and 4, 149,504] -> 50,000 (kNN patches of a 50k
     cloud, as the recombination receives them, and a random cloud), its
     10k shape [1, 28,672] -> 10,000, a ragged [1, 100,003] -> 33,000
     whose every pick is a tie and [1, 200,000] past the registers (one
     16-CTA cluster per cloud), with device us a pick and the share of
     unit passes the cluster kernel skipped, and both kernels at B = 1 and
     73 for growing N up to 16,383 (the dispatch's crossover);
     K1 in f32 within CONV_TOL and in bf16 within conv_bf16_bound, a bound
     per element derived from the epilogue kernel, plain version and TPU
     kernel share (each shape prints its largest ratio of error to bound),
     also at B = 1 and B = 3 (a cloud's first and last tiles, an odd tile
     count), at Cin = 35 (padded) and at the rooms model's Cout = 512
     (channel tiles), each shape's time beside cuDNN's and beside the host
     clock over synchronised calls;
     K2 (voxelize) torch.equal, grid and counts, to its plain version run
     on the CPU from the same inputs and to a second kernel call, also at
     PVDL_SNPP's (4096, 32, 67) and (64, 8, 512) at B = 4;
     K3 (devoxelize + SE mean) within DEVOX_TOL of its plain version (f32
     torch.equal), its mean torch.equal to grid_mean_fixed_order run on
     the CPU, a second call bit-equal, the call without the mean equal,
     also at C = 35 and 36 (one element a load), B = 1 and a ragged tile,
     and one device function launched per call;
     K4 (ball query + group) at the SA shapes: the rows entry torch.equal
     to its plain version, and the SA module's fused entry (grouped tensor
     [p - centre | features] written directly) torch.equal to the
     module's composition (concatenate, plain gather, subtract,
     concatenate), in bf16 and f32; the fused entry is the one timed;
     K6 (3-NN interpolation) at the four FP stages: indices torch.equal
     and weights within 1e-6 of the plain version, the sum within
     INTERP_TOL, the sum alone (the model's form) torch.equal to the call
     with weights, also at a ragged N with a C of no whole 16 bytes, at
     M = 1 and 2 and on integer clouds whose picks tie exactly, with one
     device function launched per call;
     the point branch's fused GroupNorm (group_norm_act) at every distinct
     (shape, groups) of a PVDS_PUNet forward at B = 73 and a PVDL_SNPP
     forward at B = 32, as the forwards call it, in bf16 and f32, shared
     and per-cloud affine, with and without swish: within gn_bound of its
     plain formulation's f32 result (one rounding, and the two sides' f32
     statistics), two calls bit-equal; under autograd at each PVDS_PUNet
     (shape, groups), one launch a forward and the plain formulation's
     gradients, bit for bit; timed at each PVDS_PUNet call;
     then the host cost of K2b's wrapper, of its launch and of the pieces
     of the launch path, this one's and the earlier one's;
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
     device time by kernel group and the device's idle share (each traced
     window opens with spin kernels, which a trace late in a run partly
     loses in place of the path's first kernels);
  7. training: hold the training kernels, K2b (voxelize backward) and the
     backward scatter of K3, K4 and K6 (scatter_rows) in bf16 and f32,
     torch.equal to their plain versions (scatter_rows run on the CPU), and
     K7 (auction EMD, from coordinates) on a real batch at 100, 3 and 1
     rounds torch.equal to the plain version on pairwise_sqdist_ordered
     and to a second call, one device function a call, at the training
     shapes (B = 32 patches of 2048 points), and time them, K7 beside
     pairwise_sqdist (the matrix the parent's route built); time K1's
     backward (cuDNN) with and without cuDNN's deterministic algorithms;
     hold the f32 gradient of the loss at full width on the card against
     the CPU's (B = 2, dropout off, fixed timesteps) and two card runs of
     it bit-equal; two bf16 forward + backward passes at the training
     shape (bs 32, dropout, the K7 alignment, generators reseeded) bit-equal
     in every parameter's gradient; a watch step (train_step with
     return_grads) bit-equal to a plain step from the same state and
     generators, in its gradients, update, moments and EMA; log what one training step under
     torch.use_deterministic_algorithms(True, warn_only=True) warns; train
     PVDS_PUNet as shipped (bf16, AdamW, clip 1.0, EMA, the K7 alignment)
     for 31 steps through ``train`` on a synthetic PUNet tree written with
     numpy: every loss finite, the last five below the first five, the
     launch counts set to 0 just before step 20 and read just after with
     every training kernel launched, ms per step over steps 10-29 split
     into its phases (CUDA events and the host clock), a torch.profiler
     profile of step 30, one in-training evaluation after step 29 (finite
     eval/* keys and their noisy floors in metrics.jsonl, its wall time,
     the renderings where matplotlib imports), the histograms of every
     parameter and gradient at the watch step 24, the profile_dir trace of
     steps 10-14, the host time of model.train() and of the
     alignment (what the alignment span issues); and a checkpoint
     that denoise_object.load_weights reads back into a model whose
     forward on the card is bit-equal to the trained model's;
  8. rooms: PVDL_SNPP as shipped (bf16, 118,666,115 parameters, 384
     feature channels) with random weights from seed 0 on a synthetic
     ScanNet++ scene written with numpy (a 4 x 4 m floor with boxes,
     spheres and cylinders, 200,000 noisy points with outliers, a seeded
     [384, N] feature file, the mesh): the f32 forward on the card against
     the CPU at B = 1 x 4096 and the bf16 forward against it, two bf16
     forwards at B = 32 x 4096 bit-equal; K1 at each conv of that forward
     against its plain version (conv_bf16_bound), timed beside it and cuDNN;
     python -m p2p_bridge_tpu_torch.denoise_room through its main on the
     card (5 steps, k 4, batch 32 x 4096) with the launch counts set to 0
     just before it and read just after (every backbone kernel launched),
     the native host runtime required, the prediction finite and bit-equal
     over two runs, ms per batch (CUDA events), room points/s and the host
     split (seeding and KD-tree, patching, sampling, recomposition), a
     torch.profiler window over one batch; then python -m
     p2p_bridge_tpu_torch.evaluate_rooms on the scene (four finite metrics)
     and the room's Chamfer distances on the card against the CPU;
  9. objects: write a PU-Net test tree with scripts/make_synthetic_punet.py
     (3 shapes, 8192-point GT, meshes, 10k and 50k inputs at noise 0.01,
     0.02, 0.03) and run python -m p2p_bridge_tpu_torch.evaluate_objects
     through its main on the card with phase 7's checkpoint (bf16 as
     shipped, 5 steps) over the 6 cells, exact and then bucketed
     recombination, the launch counts set to 0 just before each run and
     read just after (every backbone kernel, the cluster FPS and K7
     launched), Summary_PUNet.csv with four finite metrics a cell, ms a
     cell split into denoise, CD, P2M, emd_sub and emd_exact_sub; the
     Evaluator on the noisy inputs (the floor); K7 at the evaluation's
     setting (eps 0.001, 10,000 rounds, B = 1, one shape's 2048-point
     sub-samples) torch.equal to its plain version and to a second call,
     one device function a call, its rounds, times and bound; the
     approximate EMD and get_metrics at [4, 2048] card against CPU;
 10. room training (run after phase 8, before phase 9): two synthetic
     ScanNet++ scenes from phase 8's generator (train0 with 200,000 points,
     val0 with 100,000) and their split files, made into 4096-point paired
     batches with 384 float16 feature channels by python -m
     p2p_bridge_tpu_torch.preprocess_batches (its main, two spawned
     workers, r 0.3); K2b and scatter_rows (bf16 and f32) at every
     backward shape of a PVDL_SNPP training step at B = 4 held as in phase
     7, the calls at 2^15 entries a cloud (the limit of the one-block
     sort the table build replaced) required among them, and scatter_rows
     at skewed destinations, at 65,536 entries and at its limit of 2^20
     (scatter_edge_cases), its table-build / row-pass split printed; K1's
     cuDNN backward timed against its bound; two bf16 forward + backward
     passes of PVDL_SNPP on one room batch (dropout, x_cond) bit-equal in
     every parameter's gradient; PVDL_SNPP as shipped (118,666,115
     parameters, bf16, bs 4 x 4096, AdamW, clip 1.0, EMA, no alignment)
     trained for 31 steps through ``train`` with phase 7's observer: every
     loss finite, every training kernel but K7 launched in step 20, ms a
     step over steps 10-29 by phase, patches/s, a profile of step 30, one
     in-training evaluation after step 29 with finite eval/* keys; the
     run directory (model.pt, opt.yaml as the training CLI writes it)
     through denoise_room's loader with and without the EMA, its forward
     bit-equal to the trained model's, and python -m
     p2p_bridge_tpu_torch.denoise_room with that run on the val scan.
 11. full attention, the bench, data parallelism (after phase 9): PVDS_PUNet
     at full width with attention_type "flash" (bf16 and an f32 twin; the
     attention's parameters f32): the f32 forward card vs CPU at B = 1, the
     bf16 forward against it, two bf16 forwards at B = 73 bit-equal, a 50k
     bucketed denoise with every backbone kernel and the cluster FPS
     launched; python -m p2p_bridge_tpu_torch.bench through its main (its
     JSON line printed, every pipelined output torch.equal to the
     synchronous one, the launch counts set to 0 before and read after,
     0 < mfu <= 1, no synchronising call in its profiler window of
     pipelined calls and the next call queued before the last kernel of the
     one before ended); W = 1 over NCCL: a bf16 PVDS_PUNet step (bs 32,
     dropout, K7) through the mesh torch.equal to the plain step in every
     gradient, parameter, moment and EMA, and denoise_room of a synthetic
     30,000-point scene with the mesh equal to the unsharded call; two
     spawned ranks sharing the card over gloo (which gloo collectives take
     CUDA tensors is printed): the f32 step at a global batch of 4 against
     W = 1 and the sharded f32 room against one process, within the CPU
     test's tolerances (tests/test_torch_distributed.py); and python -m
     torch.distributed.run --nproc_per_node 2 -m p2p_bridge_tpu_torch.train
     on phase 7's tree (gloo, both ranks on card 0): finite losses, one
     checkpoint, saved by rank 0.
 12. a training run carried through the file export_jax_checkpoint.py
     writes for a JAX run (run last): phase 7's trained PVDS_PUNet
     (model.pt, 31 steps) written in that layout (the weights, the EMA,
     Adam's moments and counts in flax names and layouts, about 423 MB) and
     opt.yaml beside it, imported on the card bit-equal in parameters, EMA,
     moments, Adam's step tensors, rate and counts; ``train`` resumed for 3
     steps (exact epochs) from the file, with the launch counts set to 0
     before and read after (every training kernel launched), and from
     model.pt: parameters and moments bit-equal, the file's EMA equal to
     its parameters (the copy phase its restarted count gives); python -m
     p2p_bridge_tpu_torch.denoise_object with the file (--use_ema) on a
     10,000-point cloud, finite, of the input's shape.
The line before the last is a JSON object with each kernel's launches,
errors, times (back to back, device, host per call) and bounds; the last
line is {"ok": true, "device": {...}}. Phase 10's figures are under
"room_train" on the line before the last, and each kernel's launches in a
room training step under "bf16 room train step" in its launches_by_path;
phase 11's under "phase11", phase 12's under "phase12".
"""

from __future__ import annotations

import copy
import csv
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from p2p_bridge_tpu_torch import bench as port_bench
from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch import denoise_object
from p2p_bridge_tpu_torch import denoise_room as room_cli
from p2p_bridge_tpu_torch import (evaluate_objects, evaluate_rooms, preprocess_batches, rooms,
                                  runtime)
from p2p_bridge_tpu_torch.config import pvdl_snpp, pvds_punet
from p2p_bridge_tpu_torch.data.batch import get_data_batch
from p2p_bridge_tpu_torch.data.dataloader import get_dataloader
from p2p_bridge_tpu_torch.inference import patch_based_denoise_batch
from p2p_bridge_tpu_torch import metrics as obj_metrics
from p2p_bridge_tpu_torch.metrics import emd_auction
from p2p_bridge_tpu_torch.metrics.chamfer import chamfer_distance_large
from p2p_bridge_tpu_torch.metrics.emd_auction import align_clean_to_noisy
from p2p_bridge_tpu_torch.models import evaluation as object_evaluation
from p2p_bridge_tpu_torch.models import modules
from p2p_bridge_tpu_torch.models.model_loader import (jax_checkpoint_arrays, restore_checkpoint,
                                                      restore_jax_checkpoint, save_checkpoint,
                                                      save_jax_checkpoint)
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.parallel.mesh import (initialize_distributed, make_data_mesh,
                                                shard_batch)
from p2p_bridge_tpu_torch.parallel.train_step import init_train_state, train_step
from p2p_bridge_tpu_torch.train import train, write_run_config
from p2p_bridge_tpu_torch.ops import ball_query as bq_ops
from p2p_bridge_tpu_torch.ops import conv3d_gn as conv_ops
from p2p_bridge_tpu_torch.ops import devoxelize as devox_ops
from p2p_bridge_tpu_torch.ops import fps as fps_ops
from p2p_bridge_tpu_torch.ops import group_norm as gn_ops
from p2p_bridge_tpu_torch.ops import interpolate as interp_ops
from p2p_bridge_tpu_torch.ops.knn import knn
from p2p_bridge_tpu_torch.ops import scatter as scatter_ops
from p2p_bridge_tpu_torch.ops import voxelize as vox_ops
from p2p_bridge_tpu_torch.ops.common import (pairwise_sqdist, pairwise_sqdist_exact,
                                              pairwise_sqdist_ordered)
from p2p_bridge_tpu_torch.utils.io import read_ply, read_xyz, write_ply
from p2p_bridge_tpu_torch.utils.logging import read_summary as summary_csv

REPO = Path(__file__).resolve().parent
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
CONV_TOL = {"f32": 1e-4}                      # times max|out|: another f32 order, TF32 off
DEVOX_TOL = {"f32": 1e-6, "bf16": BF16_ULP}   # times max|grid|: same order; the mean in double
INTERP_TOL = {"f32": 1e-6, "bf16": BF16_ULP}  # times max|features|: a 3-term f32 sum
FORWARD_TOL = 1e-3  # abs, times max(1, max|out_cpu|): whole f32 backbone, GPU vs CPU
# K1 bf16 is held per element by conv_bf16_bound, derived from the epilogue
# that kernel, plain version and TPU kernel share: the GroupNorm statistics
# come from the f32 accumulator y (conv + bias), y is staged in bf16, and the
# staged value is normalised (p2p_bridge_tpu/ops/pallas/wconv3d_kernel.py:
# 148-156, 176-181, 244): out = bf16(act(gamma (bf16(y) - m) rstd + beta)).
# swish's slope lies in [-0.0998, 1.0998]
SWISH_MAX_SLOPE = 1.0998
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
    # no Pallas kernel: XLA fuses the point branch's GroupNorm / AdaGN + swish
    "group_norm_act": ("p2p_bridge_tpu_torch/csrc/group_norm.cu",
                       "p2p_bridge_tpu/models/modules.py GroupNorm, AdaGN, SharedMLP, "
                       "MyGroupNormMLP (XLA, no Pallas kernel)"),
}
SERVING = ("fps", "ball_query_group", "avg_voxelize", "conv3d_gn", "trilinear_devoxelize",
           "three_nn_interpolate", "group_norm_act")  # the kernels of every denoising path's backbone
# a training step's: all but the exact recombination's FPS
TRAINING = tuple(k for k in KERNELS if k != "fps_cluster")
ROOM_TRAINING = tuple(k for k in TRAINING if k != "auction_emd")  # room pairs are aligned offline
# the kernels of one device function a launch, whose records a profile's share counts
SINGLE_FUNCTION = ("trilinear_devoxelize", "ball_query_group", "three_nn_interpolate",
                   "avg_voxelize_backward", "auction_emd")
TRAIN_B = 32  # training.bs of PVDS_PUNet
SCATTER_OLD_LIMIT = 1 << 15  # entries and rows a cloud of the one-block sort scatter_rows replaced
TRAIN_STEPS = 31  # steps 10-29 timed, 20 counted, 30 profiled
VIZ_INTERVAL = 30  # one in-training evaluation, after step 29 and before step 30
WATCH_INTERVAL = 25  # one watch step (24): parameter and gradient histograms
PROFILE_STEPS = (10, 14)  # what profile_dir traces: start + 10 to start + 14
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


# kernel -> the most distinct device functions one call of it launched
DEVICE_LAUNCHES: dict = {}
# kernel -> its last device_ms result by device function
DEVICE_SPLIT: dict = {}


def device_ms(fn, kernel: str, calls: int = 10, attempts: int = 5) -> float:
    """Device time of one call of ``fn``: the mean duration of each device
    function of ``kernel`` (KERNEL_FUNCTIONS) over its records in a
    torch.profiler trace of ``calls`` back-to-back calls, summed over the
    functions (every wrapper launches each of its device functions once a
    call). The traces drop a share of the kernel records, more late in a
    long run, so the sum of durations over ``calls`` reads low; the mean
    over the records that arrive does not. The distinct device functions a
    call go to DEVICE_LAUNCHES. A trace now and then holds no device event
    at all, so an empty one is taken again, up to ``attempts`` times in
    all; then the time is not measured (nan)."""
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
                n, ms = split.get(fn_name, (0, 0.0))
                split[fn_name] = (n + 1, ms + dur / 1e3)
        if split:
            break
        log(f"  {kernel}: trace {attempt} of {attempts} holds none of its device functions")
    else:
        log(f"  {kernel}: {attempts} traces hold none of its device functions: device time "
            "not measured")
        return float("nan")
    DEVICE_LAUNCHES[kernel] = max(DEVICE_LAUNCHES.get(kernel, 0), len(split))
    times = {f: ms / n for f, (n, ms) in split.items()}
    DEVICE_SPLIT[kernel] = times
    recorded = sum(n for n, _ in split.values()) / (calls * len(split))
    if len(times) > 1 or recorded < 1.0:
        log(f"  {kernel} device ms per call by function: "
            + ", ".join(f"{f} {ms:.4f}" for f, ms in times.items())
            + f"; the trace holds {recorded:.2f} of the launches")
    return sum(times.values())


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


def synced_ms(fn, runs: int = 3) -> float:
    """Median host-clock time of one synchronised call of ``fn``: the
    ground truth that CUDA events and the profiler's device time are held
    to for calls long enough (milliseconds) that launch work is noise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
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
               "library_ms": self.library_ms,
               "device_ms": None if math.isnan(self.device_ms) else self.device_ms,
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
    points tie too), and the last point of each range of ``chunk`` indices
    repeated as the first of the next: ties across the cluster kernel's
    CTAs (chunk = a CTA's range) or across lanes and warps (chunk = 32)."""
    half = np.round(surface_cloud(rng, (n + 1) // 2) * 64) / 64
    x = np.concatenate([half, half])[rng.permutation(2 * len(half))][:n]
    for c in range(1, -(-n // chunk)):
        x[c * chunk] = x[c * chunk - 1]
    return x.astype(np.float32)


def knn_patch_cloud(rng, n: int, dev) -> torch.Tensor:
    """What the exact recombination receives from an n-point object: the
    kNN patches (PATCH points, in kNN order) around its int(3 n / PATCH)
    FPS seeds, one after another: [1, S * PATCH, 3]."""
    pcl = torch.from_numpy(surface_cloud(rng, n)).to(dev)[None]
    seeds = fps_ops.furthest_point_sample_and_gather(pcl, int(3 * n / PATCH))
    _, idx = knn(seeds, pcl, PATCH)
    return pcl[0][idx[0].long()].reshape(1, -1, 3).contiguous()


def cluster_skip_share(x, m) -> float:
    """The share (%) of the cluster kernel's unit passes that its
    bounding-box test skipped in one call on x, from the count the kernel
    hands ``fps_ops.cluster_skips``."""
    seen = []
    real = fps_ops.cluster_skips
    fps_ops.cluster_skips = lambda skipped, passes: seen.append((skipped, passes)) or skipped
    try:
        fps_ops._fps_launch("fps_cluster", x, m)
    finally:
        fps_ops.cluster_skips = real
    skipped, passes = seen[0]
    return 100.0 * int(skipped.sum()) / max(x.shape[0] * passes, 1)


def fps_crossover(rng, dev) -> dict:
    """Both K5 kernels for growing N, 511 iterations each, at B = 1 and at
    B = 73 (the one-block kernel runs a block per cloud on 132 SMs, the
    cluster kernel a cluster per cloud, a few at a time): us per iteration
    of the whole batch, indices equal to each other and to the plain
    version. The crossover is the smallest N from which the cluster kernel
    is the faster at B = 1, up to the one-block kernel's largest cloud."""
    m, rows = 512, {}
    top = fps_ops.CLUSTER_MIN_POINTS - 1
    for b, sizes in ((1, (2048, 4096, 8192, 12288, top)), (PATCHES, (4096, 8192, top))):
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
    log(f"fps crossover: at B=1 the cluster kernel is the faster from N={crossover} (None: "
        f"nowhere up to {top}); the dispatch switches at N={fps_ops.CLUSTER_MIN_POINTS}")
    return {"us_per_iteration": rows, "crossover_n_b1": crossover,
            "dispatch_n": fps_ops.CLUSTER_MIN_POINTS}


# K5's one-warp and one-block kernels on clouds whose picks tie across
# lanes and warps, and at odd N: (clouds, points, samples)
FPS_ODD = ((PATCHES, 33, 17), (PATCHES, 1000, 250), (8, 4096, 1024), (8, 4097, 1024),
           (4, 16_383, 512))


def check_fps(rng, dev, shapes) -> dict:
    """K5 at the backbone's shapes (one warp or block per cloud, "fps") and
    at the exact recombination's and the seeding's (one cluster per cloud,
    "fps_cluster"); indices torch.equal to the plain version everywhere."""
    exact_n = PATCHES * PATCH
    # (what, clouds, points, samples, calls on the path, timed runs)
    cases = [(f"sa{i} centres", PATCHES, n, m, 1, RUNS)
             for i, (n, m, _, _, _) in enumerate(shapes["sa"])]
    cases += [("bucketed recombination", PATCHES, PATCH, 685, 0, RUNS),
              ("seeding", 1, 50_000, PATCHES, 1, RUNS),
              ("exact recombination, random order", 1, exact_n, 50_000, 0, RUNS),
              # what the recombination receives: kNN patches, of a 50k and a 10k cloud
              ("exact recombination", 1, 50_000, 50_000, 1, RUNS),
              ("exact recombination 10k, kNN patches", 1, 10_000, 10_000, 0, RUNS)]
    tallies = {"fps": Tally("f32", library=False), "fps_cluster": Tally("f32", library=False)}
    extra, per_pick = {}, {}
    for what, b, n, m, calls, runs in cases:
        x = (knn_patch_cloud(rng, n, dev) if what.startswith("exact recombination") and
             "random" not in what else patches(rng, b, n, dev))
        n = x.shape[1]
        kernel = "fps_cluster" if n >= fps_ops.CLUSTER_MIN_POINTS else "fps"
        fps_equal(x, m, what)
        ms = time_ms(lambda: fps_ops.furthest_point_sample(x, m), runs)
        dms = device_ms(lambda: fps_ops.furthest_point_sample(x, m), kernel)
        hus = host_us(lambda: fps_ops.furthest_point_sample(x, m), ms)
        plain = time_ms(lambda: fps_ops.furthest_point_sample_plain(x, m), 1)
        # per iteration and point: 3 sub, 3 mul, 2 add, min, compare
        bound = tallies[kernel].add(calls, ms, plain, None, b * n * 12 + b * m * 4,
                                    10.0 * b * (m - 1) * n, 0.0, dms, hus)
        us_pick = dms / max(m - 1, 1) * 1e3
        per_pick[what] = {"device_ms": dms, "us_per_pick": us_pick, "ms": ms}
        skip = ""
        if kernel == "fps_cluster":
            per_pick[what]["skip_share"] = cluster_skip_share(x, m)
            skip = f", {per_pick[what]['skip_share']:.2f}% of unit passes skipped"
        log(f"{kernel} {what} [{b}, {n}] -> {m}: indices equal; kernel {ms:.3f} ms (device "
            f"{dms:.4f} ms, {us_pick:.3f} us a pick{skip}; host {hus:.1f} us "
            f"a call), plain {plain:.3f} ms, bound {bound:.3g} ms")
        if what == "exact recombination":
            extra = {"exact_recombination_ms": ms, "exact_recombination_device_ms": dms,
                     "exact_us_per_iteration": us_pick}
    # the SA stages on clouds whose every pick ties two indices, among them
    # neighbours across lane and warp boundaries, and odd N
    for i, (n, m, _, _, _) in enumerate(shapes["sa"]):
        x = torch.from_numpy(np.stack([tied_cloud(rng, n, 32) for _ in range(PATCHES)])).to(dev)
        fps_equal(x, m, f"sa{i} tied [{PATCHES}, {n}]")
        log(f"fps sa{i} [{PATCHES}, {n}] -> {m}, every pick a tie, ties across lanes and "
            "warps: indices equal")
    for b, n, m in FPS_ODD:
        x = patches(rng, b, n, dev)
        fps_equal(x, m, f"[{b}, {n}]")
        xt = torch.from_numpy(np.stack([tied_cloud(rng, n, 32) for _ in range(b)])).to(dev)
        fps_equal(xt, m, f"tied [{b}, {n}]")
        log(f"fps [{b}, {n}] -> {m}, random and tied: indices equal")
    # the bench's four objects, and a ragged cloud whose every pick is a tie
    x = patches(rng, 4, exact_n, dev)
    fps_equal(x, 50_000, f"[4, {exact_n}]")
    ms4 = time_ms(lambda: fps_ops.furthest_point_sample(x, 50_000), 2)
    skip4 = cluster_skip_share(x, 50_000)
    log(f"fps_cluster [4, {exact_n}] -> 50000: indices equal; kernel {ms4:.2f} ms, "
        f"{ms4 / 49_999 * 1e3:.3f} us a pick, {skip4:.2f}% of unit passes skipped")
    n = 100_003
    x = torch.from_numpy(tied_cloud(rng, n, -(-n // 16))).to(dev)[None]
    fps_equal(x, 33_000, f"ragged tied [1, {n}]")
    ms_tied, skip_tied = time_ms(lambda: fps_ops.furthest_point_sample(x, 33_000), 2), \
        cluster_skip_share(x, 33_000)
    log(f"fps_cluster ragged [1, {n}] -> 33000, every pick a tie, ties across the 16 CTAs' "
        f"ranges: indices equal; {ms_tied / 32_999 * 1e3:.3f} us a pick, {skip_tied:.2f}% of "
        "unit passes skipped")
    # past the registers (N above 163,840): distances in a global scratch row
    x = patches(rng, 1, 200_000, dev)
    fps_equal(x, 3000, "[1, 200000], points past the registers")
    ms_spill, skip_spill = time_ms(lambda: fps_ops.furthest_point_sample(x, 3000), 2), \
        cluster_skip_share(x, 3000)
    log("fps_cluster [1, 200000] -> 3000 (2,260 points a CTA past the registers): indices "
        f"equal; {ms_spill / 2999 * 1e3:.3f} us a pick, {skip_spill:.2f}% of unit passes skipped")
    extra.update(four_clouds_ms=ms4, four_clouds_skip_share=skip4, tied_skip_share=skip_tied,
                 spill_skip_share=skip_spill, crossover=fps_crossover(rng, dev))
    tallies["fps_cluster"].extra = extra
    tallies["fps"].extra = {"per_call": per_pick}
    return {name: {"f32": t} for name, t in tallies.items()}


def sa_composition(centers, pts, feat, radius, k):
    """The set-abstraction module's grouping as plain ops: [coords | features]
    rows, the plain gather, subtract the centre, concatenate."""
    rows = torch.cat([pts.to(feat.dtype), feat], dim=-1)
    both, idx = bq_ops.ball_query_group_plain(centers, pts, rows, radius, k)
    rel = both[..., :3] - centers[:, :, None, :].to(both.dtype)
    return torch.cat([rel, both[..., 3:]], dim=-1), idx


def ball_query_equal(rng, dev, name, dt, b, n, m, radius, k, c):
    """K4's rows entry torch.equal to its plain version and its fused entry
    (the SA module's) torch.equal to the SA module's composition, indices
    equal throughout. Returns the inputs."""
    pts = patches(rng, b, n, dev)
    centers = pts[:, :m].contiguous()
    feat = torch.randn(b, n, c - 3, device=dev).to(dt)
    rows = torch.cat([pts.to(dt), feat], dim=-1)
    got_g, got_i = bq_ops.ball_query_group(centers, pts, rows, radius, k)
    want_g, want_i = bq_ops.ball_query_group_plain(centers, pts, rows, radius, k)
    fused_g, fused_i = bq_ops.ball_query_group_rel(centers, pts, feat, radius, k)
    comp_g, comp_i = sa_composition(centers, pts, feat, radius, k)
    torch.cuda.synchronize()
    what = f"ball query {name} B={b} {n}->{m}"
    if not (torch.equal(got_i, want_i) and torch.equal(fused_i, want_i)
            and torch.equal(comp_i, want_i)):
        raise AssertionError(f"{what}: indices differ")
    if not torch.equal(got_g, want_g):
        raise AssertionError(f"{what}: gathered rows differ")
    if not (fused_g.dtype == dt and torch.equal(fused_g, comp_g)):
        raise AssertionError(f"{what}: the fused grouping differs from the SA module's "
                             "composition")
    return pts, centers, feat, rows


def check_ball_query(rng, dev, shapes) -> dict:
    """K4 at the SA shapes: the old entry (rows gathered as they are) and the
    fused entry the SA module calls (grouped tensor written directly), each
    torch.equal to its plain version; the fused entry is the one timed."""
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=False)
        for n, m, radius, k, c in shapes["sa"]:
            pts, centers, feat, rows = ball_query_equal(rng, dev, name, dt, PATCHES, n, m,
                                                        radius, k, c)
            old_ms = time_ms(lambda: bq_ops.ball_query_group(centers, pts, rows, radius, k))
            def fused():
                return bq_ops.ball_query_group_rel(centers, pts, feat, radius, k)
            ms = time_ms(fused)
            dms = device_ms(fused, "ball_query_group")
            hus = host_us(fused, ms)
            plain = time_ms(lambda: sa_composition(centers, pts, feat, radius, k))
            # the distance tests this data needs: up to the K-th hit, or all N
            hits = (pairwise_sqdist_exact(centers, pts) < bq_ops._radius_sq(radius)).cumsum(-1)
            kth = torch.where(hits[..., -1] >= k, (hits < k).sum(-1) + 1,
                              torch.full_like(hits[..., -1], n))
            scanned = kth.sum().item()
            # points, features and centres read once, grouped and idx written once
            nbytes = (PATCHES * (m + n) * 12 + PATCHES * n * (c - 3) * esize(dt)
                      + PATCHES * m * k * (c * esize(dt) + 4))
            bound = tally.add(1, ms, plain, None, nbytes, 8.0 * scanned, 0.0, dms, hus)
            tally.extra.setdefault("rows_entry_ms", 0.0)
            tally.extra["rows_entry_ms"] += old_ms
            log(f"ball_query_group {name} {n}->{m} r={radius} C={c}: idx, rows and the fused "
                f"grouping equal; fused kernel {ms:.3f} ms (device {dms:.4f} ms, host "
                f"{hus:.1f} us a call), rows entry {old_ms:.3f} ms, plain composition "
                f"{plain:.3f} ms, bound {bound:.3g} ms")
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


def ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values in the binade of |v| (8 significant
    bits: 2^(e - 8) for |v| in [2^(e-1), 2^e))."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def conv_bf16_bound(args, act, got, want, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """Per element, the most K1 bf16 (``got``) and its plain version
    (``want``) may differ on the inputs ``args`` (x, w, bias, gamma, beta).

    Both take the statistics m, rstd of a group from the f32 accumulator y
    and normalise bf16(y), but they sum y and the statistics in other
    orders. Where y lies near a bf16 rounding boundary the two staged values
    land one bf16 ulp of |y| apart; z = gamma (bf16(y) - m) rstd + beta
    carries that step times |gamma| rstd, swish times at most its slope s,
    and each side then rounds its output by at most half an ulp of the
    larger of the two:

      |got - want| <= s (|gamma| rstd (ulp(|y|) + dy + dm)
                         + |gamma (bf16(y) - m)| rstd dr + da) + ulp(max |out|)

    with the f32 terms of the summation orders: a sum of n terms computed
    pairwise or in blocks errs by at most about log2(n) roundings of the
    sum of |terms|, taken twice, L(n) = 2 log2(n) 2^-24. So
    dy = L(27 Cin) (|x| * |w| + |bias|) for the accumulator; over a group of
    n values dm = L(n) mean|y| for the mean and, for the variance
    v = E[y^2] - m^2, dv = L(n) (E[y^2] + 2 |m| mean|y|), which moves rstd by
    dr = dv / (2 (v + eps)) relative; and da = 4 2^-24 (|gamma (bf16(y) - m)|
    rstd + |beta|) for the affine's own roundings (a fused multiply-add or
    not)."""
    x, w, b, gamma, beta = args
    xc, wc = x.float().permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xc, wc, b.float(), padding=1).permute(0, 2, 3, 4, 1)
    terms = F.conv3d(xc.abs(), wc.abs(), b.float().abs(), padding=1).permute(0, 2, 3, 4, 1)
    B, C = y.shape[0], y.shape[-1]
    shape = (B, -1, groups, C // groups)
    y, terms = y.reshape(shape), terms.reshape(shape)
    n = y.shape[1] * y.shape[3]

    def rounds(count: int) -> float:
        return 2.0 * math.log2(count) * 2.0 ** -24

    m = y.mean(dim=(1, 3), keepdim=True)
    sq = (y * y).mean(dim=(1, 3), keepdim=True)
    var = sq - m * m
    rstd = torch.rsqrt(var + eps)
    mean_abs = y.abs().mean(dim=(1, 3), keepdim=True)
    dm = rounds(n) * mean_abs
    dr = rounds(n) * (sq + 2 * m.abs() * mean_abs) / (2 * (var + eps))
    dy = rounds(27 * x.shape[-1]) * terms
    g = gamma.float().expand(B, C).reshape(B, 1, groups, C // groups).abs()
    bt = beta.float().expand(B, C).reshape(B, 1, groups, C // groups).abs()
    scale = g * rstd
    centred = (y.to(torch.bfloat16).float() - m).abs() * scale
    dz = scale * (ulp_bf16(y) + dy + dm) + centred * dr + 4 * 2.0 ** -24 * (centred + bt)
    out = torch.maximum(got.float().abs(), want.float().abs()).reshape(shape)
    return ((SWISH_MAX_SLOPE if act else 1.0) * dz + ulp_bf16(out)).reshape(got.shape)


def conv_error(name, args, act, what) -> tuple:
    """K1 against its plain version on the same inputs -> (max abs error,
    the largest ratio of error to bound); raises where it exceeds 1. The
    bound: f32, CONV_TOL times max|out|; bf16, conv_bf16_bound per
    element."""
    got = conv_ops.conv3d_gn(*args, 8, 1e-5, act)
    want = conv_ops.conv3d_gn_plain(*args, 8, 1e-5, act)
    torch.cuda.synchronize()
    if not (got.dtype == args[0].dtype and got.shape == want.shape):
        raise AssertionError(f"conv3d_gn {name} {what}: {got.dtype} {tuple(got.shape)}, "
                             f"want {want.dtype} {tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if name == "bf16":
        ratio = (diff / conv_bf16_bound(args, act, got, want)).max().item()
    else:
        ratio = err / (CONV_TOL[name] * want.float().abs().max().item())
    if not ratio <= 1.0:
        raise AssertionError(f"conv3d_gn {name} {what}: max err {err}, {ratio:.3f} of its bound")
    return err, ratio


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
            err, ratio = conv_error(name, (x, w, b, gamma, beta), act, f"r={r} {cin}->{cout}")
            tally.extra["max_ratio_to_bound"] = max(tally.extra.get("max_ratio_to_bound", 0.0),
                                                    ratio)
            ms = time_ms(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act))
            dms = device_ms(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act),
                            "conv3d_gn")
            hus = host_us(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act), ms)
            single = time_ms(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act),
                             back_to_back=False)
            tally.single_call_ms += calls * single
            wall = synced_ms(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act))
            tally.extra["synced_ms"] = tally.extra.get("synced_ms", 0.0) + calls * wall
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
                f"({ratio:.3f} of its bound); kernel {ms:.3f} ms (device {dms:.4f} ms, host {hus:.1f} us "
                f"a call; {flop / ms / 1e9:.2f} TFLOP/s, "
                f"{bound / ms:.3f} of the bound {bound:.3g} ms), one call alone {single:.3f} ms "
                f"(host clock, synchronised: {wall:.3f} ms), "
                f"plain {plain:.3f} ms, cuDNN conv + GroupNorm {lib:.3f} ms "
                f"(kernel / cuDNN {ms / lib:.3f})")
            del x
            torch.cuda.empty_cache()
        out[name] = tally
    # a cloud's first and last tiles alone (B = 1) and an odd tile count
    # (B = 3); Cout = 512 (PVDL_SNPP's widest conv) takes two channel tiles
    # in bf16 and four in f32, and Cin = 35 is padded (64 in bf16, 36 in f32)
    for name, dt in DTYPES.items():
        for B in (1, 3):
            for r, cin, cout, act in ((8, 256, 256, False), (32, 35, 32, True),
                                      (8, 512, 512, True)):
                for shared in (False, True):
                    args = conv_inputs(gen, dev, dt, B, r, cin, cout, shared)
                    err, ratio = conv_error(name, args, act, f"B={B} r={r} {cin}->{cout}")
                    out[name].err = max(out[name].err, err)
                    extra = out[name].extra
                    extra["max_ratio_to_bound"] = max(extra.get("max_ratio_to_bound", 0.0), ratio)
                    log(f"conv3d_gn {name} B={B} r={r} {cin}->{cout} "
                        f"{'shared' if shared else 'per-cloud'} affine: max err {err:.3g} "
                        f"({ratio:.3f} of its bound)")
    return out


def devoxelize_equal(rng, dev, name, dt, b, n, r, c):
    """K3 with the mean at (b, n, r, c): the output within DEVOX_TOL of the
    plain version (f32: torch.equal), the mean torch.equal to
    grid_mean_fixed_order run on the CPU, a second call bit-equal, and the
    call without the mean equal to the output. Returns the inputs and the
    output's error."""
    pts = patches(rng, b, n, dev)
    _, cont = vox_ops.normalize_coords_to_voxels(pts, r)
    grid = torch.randn(b, r, r, r, c, device=dev).to(dt)
    got, got_m = devox_ops.trilinear_devoxelize_with_mean(grid, cont, r)
    again, again_m = devox_ops.trilinear_devoxelize_with_mean(grid, cont, r)
    alone = devox_ops.trilinear_devoxelize(grid, cont, r)
    want = devox_ops.trilinear_devoxelize_plain(grid, cont, r)
    want_m = devox_ops.grid_mean_fixed_order(grid.cpu()).to(dev)
    torch.cuda.synchronize()
    what = f"devoxelize {name} B={b} N={n} r={r} C={c}"
    err = (got.float() - want.float()).abs().max().item()
    tol = DEVOX_TOL[name] * grid.float().abs().max().item()
    if not (got.dtype == dt and got_m.dtype == torch.float32 and err <= tol):
        raise AssertionError(f"{what}: max err {err} > {tol}")
    if name == "f32" and not torch.equal(got, want):
        raise AssertionError(f"{what}: f32 output not bit-equal to the plain version")
    if not torch.equal(got_m, want_m):
        raise AssertionError(f"{what}: mean differs from grid_mean_fixed_order by "
                             f"{(got_m - want_m).abs().max().item()}")
    if not (torch.equal(again, got) and torch.equal(again_m, got_m) and torch.equal(alone, got)):
        raise AssertionError(f"{what}: a second call or the call without the mean differs")
    mean_err = (got_m - devox_ops.grid_mean_plain(grid)).abs().max().item()
    return grid, cont, err, tol, mean_err


# off the main path: C that 16 bytes do not divide (one element a load),
# a single cloud and a ragged last tile
DEVOX_ODD = ((4, 2048, 32, 35), (4, 2048, 16, 36), (1, 1000, 8, 64))


def check_devoxelize(rng, dev, shapes) -> dict:
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=True)
        for b, n, r, c in DEVOX_ODD:
            devoxelize_equal(rng, dev, name, dt, b, n, r, c)
            log(f"trilinear_devoxelize {name} B={b} N={n} r={r} C={c}: output and mean equal")
        for (n, r, c), calls in counted((n, r, cout) for n, r, _, cout in shapes["pvconv"]):
            grid, cont, err, tol, mean_err = devoxelize_equal(rng, dev, name, dt, PATCHES, n,
                                                              r, c)
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
                f"(tol {tol:.3g}), mean bit-equal to the fixed order ({mean_err:.3g} from "
                f"the f32 mean), two calls bit-equal; kernel {ms:.3f} ms (device {dms:.4f} "
                f"ms, {DEVICE_LAUNCHES.get('trilinear_devoxelize', 0)} device functions a call, "
                f"host {hus:.1f} us a call), plain {plain:.3f} ms, grid_sample {lib} ms, "
                f"bound {bound:.3g} ms")
            del gc
        if DEVICE_LAUNCHES.get("trilinear_devoxelize") != 1:
            raise AssertionError(f"trilinear_devoxelize launched "
                                 f"{DEVICE_LAUNCHES.get('trilinear_devoxelize')} device "
                                 "functions a call in its traces, not 1")
        out[name] = tally
    return out


def interp_equal(what, dt, pts, centers, feat) -> tuple:
    """K6 against its plain version on the card: indices torch.equal,
    weights within 1e-6, the sum within INTERP_TOL, the sum alone (the
    model's form) torch.equal to the call with weights -> (weights error,
    sum error)."""
    name = "bf16" if dt == torch.bfloat16 else "f32"
    got, got_w, got_i = interp_ops.three_nn_interpolate(pts, centers, feat)
    want, want_w, want_i = interp_ops.three_nn_interpolate_plain(pts, centers, feat)
    torch.cuda.synchronize()
    if not torch.equal(got_i, want_i):
        raise AssertionError(f"three_nn {name} {what}: {(got_i != want_i).sum().item()} indices "
                             "differ")
    err_w = (got_w - want_w).abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    tol = INTERP_TOL[name] * feat.float().abs().max().item()
    if not (got.dtype == dt and err_w <= 1e-6 and err <= tol):
        raise AssertionError(f"three_nn {name} {what}: weights {err_w}, out {err} > {tol}")
    alone = interp_ops.nearest_neighbor_interpolate(pts, centers, feat)
    if not torch.equal(alone, got):
        raise AssertionError(f"three_nn {name} {what}: the sum alone differs")
    return err_w, err


# (B, N, M, C, integer coordinates): a ragged N with a C of no whole
# 16 bytes (the scalar gather), M = 1 and 2, and integer clouds whose
# picks tie exactly, at the split the 32- and 2048-point stages take
INTERP_ODD = ((PATCHES, 1001, 250, 35, False), (4, 777, 1, 64, False), (4, 777, 2, 64, False),
              (8, 2048, 512, 192, True), (PATCHES, 32, 8, 576, True))


def check_interpolate(rng, dev, shapes) -> dict:
    out = {}
    gen = torch.Generator(device=dev).manual_seed(9)
    for name, dt in DTYPES.items():
        tally = Tally(name, library=False)
        for b, n, m, c, integer in INTERP_ODD:
            if integer:
                pts = torch.randint(-3, 4, (b, n, 3), generator=gen, device=dev).float()
                centers = torch.randint(-3, 4, (b, m, 3), generator=gen, device=dev).float()
            else:
                pts = patches(rng, b, n, dev)
                centers = torch.rand(b, m, 3, generator=gen, device=dev) * 2 - 1
            feat = torch.randn(b, m, c, device=dev, generator=gen).to(dt)
            err_w, err = interp_equal(f"[{b}] {n}<-{m} C={c}", dt, pts, centers, feat)
            log(f"three_nn_interpolate {name} [{b}] {n}<-{m} C={c}"
                f"{' integer' if integer else ''}: indices equal, weights {err_w:.3g}, "
                f"max err {err:.3g}")
        for n, m, c in shapes["fp"]:
            pts = patches(rng, PATCHES, n, dev)
            centers = pts[:, :m].contiguous()  # coarse points are a subset
            feat = torch.randn(PATCHES, m, c, device=dev).to(dt)
            err_w, err = interp_equal(f"{n}<-{m}", dt, pts, centers, feat)
            ms = time_ms(lambda: interp_ops.nearest_neighbor_interpolate(pts, centers, feat))
            dms = device_ms(lambda: interp_ops.nearest_neighbor_interpolate(pts, centers, feat),
                            "three_nn_interpolate")
            hus = host_us(lambda: interp_ops.nearest_neighbor_interpolate(pts, centers, feat), ms)
            plain = time_ms(lambda: interp_ops.three_nn_interpolate_plain(pts, centers, feat))
            nbytes = PATCHES * (n + m) * 12 + PATCHES * (m + n) * c * esize(dt)
            # per (point, centre) pair: 3 sub, 3 mul, 2 add
            bound = tally.add(1, ms, plain, None, nbytes, 8.0 * PATCHES * n * m,
                              max(err, err_w), dms, hus)
            tally.extra.setdefault("per_shape", []).append(
                {"shape": [n, m, c], "ms": ms, "device_ms": dms, "host_us": hus,
                 "bound_ms": bound})
            log(f"three_nn_interpolate {name} {n}<-{m} C={c}: indices equal, weights {err_w:.3g}, "
                f"max err {err:.3g}; kernel {ms:.4f} ms (device {dms:.4f} ms, "
                f"host {hus:.1f} us a call), plain {plain:.3f} ms, "
                f"bound {bound:.3g} ms")
        out[name] = tally
    if DEVICE_LAUNCHES.get("three_nn_interpolate") != 1:
        raise AssertionError(f"three_nn_interpolate launched "
                             f"{DEVICE_LAUNCHES.get('three_nn_interpolate')} device functions a "
                             "call in its traces, not 1")
    return out


def group_norm_calls(model, *inputs) -> list:
    """[((shape, groups, per-cloud affine, swish, out dtype), calls)] of the
    group_norm_act calls of one forward of ``model`` under no_grad."""
    calls = []
    real = modules.group_norm_act

    def record(x, gamma, beta, groups, eps=1e-5, act=False, out_dtype=None):
        calls.append((tuple(x.shape), groups, gamma.dim() == 2, act, out_dtype or x.dtype))
        return real(x, gamma, beta, groups, eps, act, out_dtype)

    modules.group_norm_act = record
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        modules.group_norm_act = real
    return counted(calls)


def main_path_norms(dev) -> dict:
    """{config: group_norm_calls of one bf16 forward}: PVDS_PUNet at B =
    PATCHES x PATCH points, PVDL_SNPP at B = ROOM_BATCH x ROOM_PATCH with
    ROOM_FEATS feature channels (random weights and inputs)."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, cfg, b, n, feats in (("PVDS_PUNet", pvds_punet(), PATCHES, PATCH, 0),
                                   ("PVDL_SNPP", pvdl_snpp(), ROOM_BATCH, ROOM_PATCH, ROOM_FEATS)):
        model = build_unet_from_config(cfg).eval().to(dev)
        x = torch.rand(b, n, 3, device=dev, generator=gen) - 0.5
        t = torch.full((b,), 500.0, device=dev)
        cond = (torch.randn(b, n, feats, device=dev, generator=gen),) if feats else ()
        out[name] = group_norm_calls(model, x, t, *cond)
        log(f"group_norm_act calls of one bf16 {name} forward at B={b}: "
            f"{sum(c for _, c in out[name])} ({len(out[name])} distinct)")
        del model
    torch.cuda.empty_cache()
    return out


def gn_bound(args, groups, act, want, out_dtype, eps: float = 1e-5) -> torch.Tensor:
    """Per element, how far the fused kernel may lie from its plain
    formulation's f32 result ``want`` on the inputs ``args`` (x, gamma,
    beta).

    The kernel rounds its f32 result once: half an ulp of the output type,
    at most one ulp of ``want``'s binade for bf16 and 2^-23 |want| for f32.
    Its statistics (double) and the plain formulation's (f32 sums of n
    values of a group) differ by the f32 terms of conv_bf16_bound's
    analysis: L(n) = 2 log2(n) 2^-24 for a sum, dm = L(n) mean|x| for the
    mean, dr = L(n) (E[x^2] + 2 |m| mean|x|) / (2 (v + eps)) relative for
    rstd, and 4 2^-24 of the affine's terms for its roundings; swish
    multiplies them by at most its slope:

      |got - want| <= s (|gamma| rstd dm + |gamma (x - m)| rstd dr
                         + 4 2^-24 (|gamma (x - m)| rstd + |beta|)) + last rounding
    """
    x, gamma, beta = args
    B, C = x.shape[0], x.shape[-1]
    xg = x.double().reshape(B, -1, groups, C // groups)
    n = xg.shape[1] * xg.shape[3]
    rounds = 2.0 * math.log2(max(n, 2)) * 2.0 ** -24
    m = xg.mean(dim=(1, 3), keepdim=True)
    sq = (xg * xg).mean(dim=(1, 3), keepdim=True)
    var = (sq - m * m).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    mean_abs = xg.abs().mean(dim=(1, 3), keepdim=True)
    dm = rounds * mean_abs
    dr = rounds * (sq + 2 * m.abs() * mean_abs) / (2 * (var + eps))
    g = gamma.double().expand(B, C).reshape(B, 1, groups, C // groups).abs()
    bt = beta.double().expand(B, C).reshape(B, 1, groups, C // groups).abs()
    centred = (xg - m).abs() * rstd * g
    dz = g * rstd * dm + centred * dr + 4 * 2.0 ** -24 * (centred + bt)
    last = ulp_bf16(want) if out_dtype == torch.bfloat16 else 2.0 ** -23 * want.abs()
    return ((SWISH_MAX_SLOPE if act else 1.0) * dz).reshape(want.shape).float() + last


def group_norm_error(args, groups, act, out_dtype) -> tuple:
    """The kernel against the plain formulation on the same inputs, within
    gn_bound of its f32 result, and a second call bit-equal; -> (max abs
    error, the largest ratio of error to bound)."""
    got = gn_ops.group_norm_act(*args, groups, 1e-5, act, out_dtype)
    again = gn_ops.group_norm_act(*args, groups, 1e-5, act, out_dtype)
    want = gn_ops.group_norm_act_plain(*args, groups, 1e-5, act, torch.float32)
    torch.cuda.synchronize()
    if not (got.dtype == out_dtype and got.shape == want.shape and torch.equal(got, again)):
        raise AssertionError(f"group_norm_act: {got.dtype} {tuple(got.shape)}, two calls equal "
                             f"{torch.equal(got, again)}")
    diff = (got.float() - want).abs()
    return diff.max().item(), (diff / gn_bound(args, groups, act, want, out_dtype)).max().item()


def gn_inputs(gen, dev, shape, dt, per_cloud):
    """x (mean 0.5, unit spread, in dt), gamma near 1, beta near 0, [B, C]
    per cloud or [C] shared, f32."""
    B, C = shape[0], shape[-1]
    x = (torch.randn(shape, device=dev, generator=gen) + 0.5).to(dt)
    affine = (B, C) if per_cloud else (C,)
    gamma = 1 + 0.1 * torch.randn(affine, device=dev, generator=gen)
    beta = 0.1 * torch.randn(affine, device=dev, generator=gen)
    return x, gamma, beta


def group_norm_autograd_equal(gen, dev, shape, groups, dt) -> None:
    """Under autograd on the card (per-cloud affine, swish): the forward is
    one launch, equal to the call without a gradient; the backward launches
    none, and its gradients of x, gamma and beta equal autograd's through
    the plain formulation on the same inputs."""
    x, gamma, beta = gn_inputs(gen, dev, shape, dt, True)
    with torch.no_grad():
        ref = gn_ops.group_norm_act(x, gamma, beta, groups, 1e-5, True)
    leaves = [t.requires_grad_(True) for t in (x, gamma, beta)]
    weight = torch.randn(shape, device=dev, generator=gen)
    before = kernels.launch_counts["group_norm_act"]
    got = gn_ops.group_norm_act(*leaves, groups, 1e-5, True)
    g_got = torch.autograd.grad((got.float() * weight).sum(), leaves)
    launched = kernels.launch_counts["group_norm_act"] - before
    want = gn_ops.group_norm_act_plain(*leaves, groups, 1e-5, True)
    g_want = torch.autograd.grad((want.float() * weight).sum(), leaves)
    equal = [torch.equal(a, b) for a, b in zip(g_got, g_want)]
    if not (launched == 1 and torch.equal(got.detach(), ref) and all(equal)):
        raise AssertionError(f"group_norm_act under autograd {dt} {shape} / {groups}: {launched} "
                             f"launches, forward equal {torch.equal(got.detach(), ref)}, "
                             f"gradients of x, gamma, beta equal {equal}")


def check_group_norm(dev) -> dict:
    """The fused point-branch GroupNorm against its plain formulation at
    every distinct (shape, groups) of a PVDS_PUNet forward at B = 73 and a
    PVDL_SNPP forward at B = 32, in bf16 and f32, shared and per-cloud
    affine, with and without swish; under autograd at each PVDS_PUNet
    (shape, groups) (group_norm_autograd_equal); then timed at each call as
    the forward makes it (bf16, and the f32 twin's), beside the plain
    formulation. Bound: x read twice, y written once and the affine tables
    read, over 3.35 TB/s (12 f32 operations a value do not bind)."""
    calls = main_path_norms(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    worst, errs = {"bf16": 0.0, "f32": 0.0}, {"bf16": 0.0, "f32": 0.0}
    for name, recorded in calls.items():
        for (shape, groups) in dict.fromkeys((s, g) for (s, g, _, _, _), _ in recorded):
            for dname, dt in DTYPES.items():
                for per_cloud in (False, True):
                    x, gamma, beta = gn_inputs(gen, dev, shape, dt, per_cloud)
                    for act in (False, True):
                        for out_dtype in dict.fromkeys((dt, torch.float32)):
                            err, ratio = group_norm_error((x, gamma, beta), groups, act,
                                                          out_dtype)
                            if not ratio <= 1.0:
                                raise AssertionError(
                                    f"group_norm_act {name} {dname} {shape} / {groups} per-cloud "
                                    f"{per_cloud} act {act} -> {out_dtype}: {ratio:.3f} of its "
                                    "bound")
                            worst[dname] = max(worst[dname], ratio)
                            errs[dname] = max(errs[dname], err)
                    del x
            log(f"group_norm_act {name} {shape} / {groups}: bf16 and f32, shared and per-cloud, "
                f"with and without swish, within gn_bound (largest ratio to it so far "
                f"{worst['bf16']:.3f} bf16, {worst['f32']:.3f} f32)")
        torch.cuda.empty_cache()
    shapes = dict.fromkeys((s, g) for (s, g, _, _, _), _ in calls["PVDS_PUNet"])
    for dt in DTYPES.values():
        for shape, groups in shapes:
            group_norm_autograd_equal(gen, dev, shape, groups, dt)
    log(f"group_norm_act under autograd at {len(shapes)} PVDS_PUNet shapes, bf16 and f32: one "
        "launch a forward, equal to the call without a gradient; none in the backward, whose "
        "gradients equal the plain formulation's")
    torch.cuda.empty_cache()
    out = {}
    for dname, dt in DTYPES.items():
        tally = Tally(dname, library=False)
        for (shape, groups, per_cloud, act, out_dtype), n in calls["PVDS_PUNet"]:
            out_dtype = out_dtype if dt == torch.bfloat16 else torch.float32
            x, gamma, beta = gn_inputs(gen, dev, shape, dt, per_cloud)

            def kernel():
                return gn_ops.group_norm_act(x, gamma, beta, groups, 1e-5, act, out_dtype)

            def plain():
                return gn_ops.group_norm_act_plain(x, gamma, beta, groups, 1e-5, act, out_dtype)

            ms = time_ms(kernel)
            dms = device_ms(kernel, "group_norm_act")
            hus = host_us(kernel, ms)
            plain_ms = time_ms(plain)
            values = x.numel()
            # x read once and y written once: the kernel's second read of x
            # (its apply pass) is its own cost, not the bound's
            nbytes = values * (x.element_size() + esize(out_dtype)) + 2 * gamma.numel() * 4
            bound = tally.add(n, ms, plain_ms, None, nbytes, 12.0 * values, 0.0, dms, hus)
            log(f"group_norm_act {dname} {shape} / {groups} x{n} ({'per-cloud' if per_cloud else 'shared'}"
                f", swish {act}, -> {out_dtype}): kernel {ms:.4f} ms (device {dms:.4f} ms, host "
                f"{hus:.1f} us a call; {bound / ms:.3f} of the bound {bound:.4f} ms), plain "
                f"{plain_ms:.4f} ms")
            del x
        tally.err = errs[dname]
        tally.extra["max_ratio_to_bound"] = worst[dname]
        out[dname] = tally
    torch.cuda.empty_cache()
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
        "group_norm_act": check_group_norm(dev),
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


def check_forward(model, twin, dev, cfg: dict = None, b: int = 2) -> dict:
    """The f32 twin's forward of ``b`` patches on the card against the CPU,
    the bf16 model's against the twin's (``cfg``: PVDS_PUNet as shipped by
    default)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.stack([surface_cloud(rng, PATCH) for _ in range(b)]))
    t = torch.from_numpy(np.array([700.0, 300.0], np.float32)[:b])
    cfg = copy.deepcopy(cfg or pvds_punet())
    cfg["model"]["compute_dtype"] = "f32"
    cpu_model = build_unet_from_config(cfg).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in twin.state_dict().items()})
    with torch.no_grad():
        want = cpu_model(x, t).numpy()
        got32 = twin(x.to(dev), t.to(dev)).cpu().numpy()
        got16 = model(x.to(dev), t.to(dev)).cpu().numpy()
    err = float(np.abs(got32 - want).max())
    tol = FORWARD_TOL * max(1.0, float(np.abs(want).max()))
    log(f"f32 forward [{b}, {PATCH}, 3] card vs CPU: max err {err:.3g} (tol {tol:.3g}), "
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
    "conv3d_gn": ("conv_ffma_kernel", "conv_wgmma_kernel", "gn_stats_kernel", "gn_apply_kernel",
                  "gn_apply_bf16_kernel"),
    "avg_voxelize": ("bucket_kernel", "rows_kernel"),
    "trilinear_devoxelize": ("devox_kernel",),
    "ball_query_group": ("ball_query_group_kernel",),
    "fps": ("fps_kernel", "fps_warp_kernel"),
    "fps_cluster": ("fps_cluster_kernel",),
    "three_nn_interpolate": ("three_nn_interp_kernel",),
    "avg_voxelize_backward": ("gather_divide_kernel",),
    "auction_emd": ("auction_kernel",),
    "scatter_rows": ("scatter_table_kernel", "scatter_rows_kernel"),
    "group_norm_act": ("point_gn_partials_kernel", "point_gn_apply_kernel"),
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


SPINS = 32  # spin kernels each traced window starts with


def start_trace(prof) -> None:
    """Start ``prof`` and run SPINS spin kernels through it, waited for:
    late in a run a trace loses the records of the first few kernels it
    sees (device_time counts them), so these go first, and device_time
    leaves them out."""
    prof.start()
    for _ in range(SPINS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def recorded_share(out: dict, launches: dict, single: tuple) -> float:
    """The share of the launches of ``single`` (kernels of one device
    function a launch) whose records a device_time result holds."""
    launched = sum(launches[k] for k in single)
    share = sum(out["kernels_by_group"].get(k, 0) for k in single) / launched
    log(f"  the trace holds {share:.3f} of the {launched} launches of {', '.join(single)}")
    return share


def profile_bf16(model, dev, mode: str) -> dict:
    """torch.profiler over one bf16 50k run with ``mode`` recombination:
    device time by kernel group and the idle share (1 - union of
    kernel/copy/set intervals / host wall time of the traced call)."""
    from torch.profiler import ProfilerActivity, profile

    bridge = P2PBridge.from_config(pvds_punet(), model)
    pcl = cloud_50k()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start_trace(prof)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    denoise(bridge, pcl, mode, dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.stop()
    out = device_time(prof, wall_ms, f"bf16 {mode}")
    out["recorded_share"] = recorded_share(
        out, kernels.launch_counts,
        ("trilinear_devoxelize", "ball_query_group", "three_nn_interpolate"))
    return out


def device_time(prof, wall_ms: float, what: str) -> dict:
    """Device time by kernel group of a finished torch.profiler run and the
    idle share: 1 - union of kernel/copy/set intervals / host wall time.
    The spin kernels of start_trace are left out; the ones missing are
    the records the trace lost at its start."""
    spans, groups, spins = [], {}, 0
    for name, ts, dur in trace_events(prof):
        if "spin_kernel" in name:
            spins += 1
            continue
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
        f"idle share {1.0 - busy_ms / wall_ms:.4f}; the trace lost {SPINS - spins} of the "
        f"{SPINS} spin kernels at its start")
    for g, (ms, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {ms:9.2f} ms ({100 * ms / wall_ms:5.1f}% of wall) in {calls:5d} kernels: {g}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "records_lost_at_start": SPINS - spins,
            "device_ms_by_group": {g: v[0] for g, v in groups.items()},
            "kernels_by_group": {g: v[1] for g, v in groups.items()}}


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
    """PVDS_PUNet as shipped, on the synthetic tree, for TRAIN_STEPS steps,
    with one evaluation (VIZ_INTERVAL), one watch step with gradients
    (WATCH_INTERVAL) and a profile of steps 10-14 (profile_dir)."""
    cfg = pvds_punet()
    cfg["data"]["data_dir"] = str(data_dir)
    cfg["data"]["pool_size"] = POOL_SIZE
    cfg["training"]["steps"] = TRAIN_STEPS
    cfg["training"]["viz_interval"] = VIZ_INTERVAL
    cfg["training"]["watch_interval"] = WATCH_INTERVAL
    cfg["training"]["watch_gradients"] = True
    cfg["output_dir"] = str(out_dir)
    cfg["profile_dir"] = str(out_dir / "trace")
    cfg["use_wandb"] = False  # the files only: wandb.init reaches wandb's servers
    return cfg


def check_voxelize_backward(rng, dev, shapes, b: int = TRAIN_B) -> dict:
    """Kernel K2b (voxelize backward) at every voxelization of a training
    step of ``b`` clouds (``shapes``), bf16 and f32: torch.equal to its plain
    version; timed beside it and torch.gather + divide."""
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=True)
        for (n, r, c), calls in counted((n, r, cin) for n, r, cin, _ in shapes["pvconv"]):
            pts = patches(rng, b, n, dev)
            vox, _ = vox_ops.normalize_coords_to_voxels(pts, r)
            idx = vox_ops.flat_voxel_index(vox, r).int()
            cnt = torch.zeros(b, r ** 3, device=dev).scatter_add_(
                1, idx.long(), torch.ones(b, n, device=dev))
            g = torch.randn(b, r ** 3, c, device=dev).to(dt)
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
            rows_idx = idx.long()[..., None].expand(b, n, c)
            den = torch.gather(cnt, 1, idx.long()).clamp_min(1.0)[..., None]
            lib = time_ms(lambda: torch.gather(g, 1, rows_idx) / den)
            lib_hus = host_us(lambda: torch.gather(g, 1, rows_idx) / den, lib)
            touched = torch.unique(idx.long() + torch.arange(b, device=dev)[:, None] * r ** 3)
            nbytes = (touched.numel() * (c * esize(dt) + 4) + b * n * 4
                      + b * n * c * esize(dt))
            bound = tally.add(calls, ms, plain, lib, nbytes, b * n * c, 0.0, dms, hus)
            log(f"avg_voxelize_backward {name} N={n} r={r} C={c} x{calls} B={b}: "
                f"bit-equal; kernel {ms:.4f} ms (device {dms:.4f} ms, host {hus:.1f} us a "
                f"call), plain {plain:.4f} ms, gather + divide (2 calls) {lib:.4f} ms "
                f"(host {lib_hus:.1f} us), bound {bound:.4g} ms")
        out[name] = tally
    return out


def scatter_cases(rng, dev, dt, shapes, b: int = TRAIN_B):
    """The backward scatters of one training step of ``b`` clouds, from the
    forwards' own indices and weights: [(what, calls, kernel wrapper, plain
    version, their arguments, rows a cloud, (flat destination rows, f32
    terms) of the one index_add_ that computes the same, bytes,
    operations)]."""
    B, cases = b, []
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
    for n, m, radius, k, w in shapes["sa"]:
        # the SA module's backward scatters the features' columns (W - 3)
        pts, c = patches(rng, B, n, dev), w - 3
        feat = torch.randn(B, n, c, device=dev).to(dt)
        _, idx = bq_ops.ball_query_group_rel(pts[:, :m].contiguous(), pts, feat, radius, k)
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


def scatter_edge_cases(rng, dev, dt, shapes):
    """Kernel scatter_rows beyond one training step's calls, at B = 4:
    skewed destinations (every entry to one row; ball query's padding, a
    centre's K slots repeating its first index; one row's run across the
    middle of the entries, where the cluster's slices meet, and a row fed
    from every slice) and K3's backward past the one-block sort's limit
    (N = 8192 at r = 32: 65,536 entries) and at the kernel's limit:
    [(what, kernel wrapper, plain version, their arguments, entries a
    cloud)]."""
    B, cases = ROOM_TRAIN_B, []
    n, m, k = 4096, 1024, 32
    gather = (bq_ops._ball_query_group_backward_cuda,
              lambda g, idx, n: bq_ops.ball_query_group_backward(g, idx, n).to(g.dtype))
    one_row = torch.full((B, m, k), 7, dtype=torch.int32, device=dev)
    padded = torch.randint(0, n, (B, m, k), device=dev, dtype=torch.int32)
    found = torch.randint(1, 5, (B, m, 1), device=dev)
    padded = torch.where(torch.arange(k, device=dev) < found, padded, padded[..., :1])
    seam = torch.randint(0, n, (B, m * k), device=dev, dtype=torch.int32)
    seam[:, m * k // 2 - 3000:m * k // 2 + 3000] = 5
    seam[:, ::97] = n - 1
    for what, idx in (("every entry to one row", one_row),
                      ("ball query padding (1-4 hits a centre)", padded),
                      ("one row across the slices' seam, one from every slice",
                       seam.view(B, m, k))):
        g = torch.randn(B, m, k, 64, device=dev).to(dt)
        cases.append((f"K4 {what} {n}<-{m}x{k} C=64", *gather, (g, idx, n), m * k))
    c = next(cout for pts, r, _, cout in shapes["pvconv"] if r == 32)
    for b, pts in ((B, 8192), (1, scatter_ops.MAX_ENTRIES // 8)):
        _, cont = vox_ops.normalize_coords_to_voxels(patches(rng, b, pts, dev), 32)
        g = torch.randn(b, pts, c, device=dev).to(dt)
        cases.append((f"K3 devoxelize N={pts} r=32 C={c} B={b}",
                      devox_ops._devoxelize_backward_cuda,
                      lambda g, cont, r: devox_ops.trilinear_devoxelize_backward(
                          g, cont, r).to(g.dtype), (g, cont, 32), 8 * pts))
    return cases


def scatter_timed(name: str, dt, what: str, kernel, plain_fn, args) -> dict:
    """One scatter_rows call: torch.equal to the plain version run on the
    CPU from the same inputs and to a second call (else it raises); card
    ms, device ms (and by device function: the table build and the row
    pass) and host us a call."""
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
    split = {} if math.isnan(dms) else dict(DEVICE_SPLIT["scatter_rows"])
    return {"ms": ms, "device_ms": dms, "split": split,
            "host_us": host_us(lambda: kernel(*args), ms)}


def split_text(split: dict) -> str:
    return " + ".join(f"{f} {ms:.4f}" for f, ms in split.items()) or "not measured"


def check_scatter(rng, dev, shapes, b: int = TRAIN_B, edges: bool = False) -> dict:
    """Kernel scatter_rows at every backward scatter of the training step
    of ``b`` clouds, bf16 and f32: torch.equal to the plain version run on
    the CPU from the same inputs and to a second call; timed beside the
    plain version on the card (index_add_) and one index_add_ of the
    precomputed terms, with the device time split between the table build
    and the row pass. The calls at the limit of the one-block sort the
    table build replaced (2^15 entries or rows a cloud) go into the row's
    "at_old_limit"; with ``edges`` the cases of scatter_edge_cases are
    checked and timed too, into "edges" (not into the step's sums)."""
    out = {}
    for name, dt in DTYPES.items():
        tally = Tally(name, library=True)
        by_function = tally.extra.setdefault("device_ms_by_function", {})
        for what, calls, kernel, plain_fn, args, rows, (flat, src), nbytes, ops in scatter_cases(
                rng, dev, dt, shapes, b):
            t = scatter_timed(name, dt, what, kernel, plain_fn, args)
            plain = time_ms(lambda: plain_fn(*args))
            acc = torch.zeros(b * rows, src.shape[-1], device=dev)
            lib = time_ms(lambda: acc.index_add_(0, flat, src))
            bound = tally.add(calls, t["ms"], plain, lib, nbytes, ops, 0.0, t["device_ms"],
                              t["host_us"])
            for f, ms in t["split"].items():
                by_function[f] = by_function.get(f, 0.0) + calls * ms
            entries = flat.numel() // b
            if SCATTER_OLD_LIMIT in (entries, rows):
                tally.extra.setdefault("at_old_limit", []).append(
                    f"{what}: {entries} entries, {rows} rows a cloud")
            log(f"scatter_rows {name} {what} x{calls} B={b} ({entries} entries, {rows} rows a "
                f"cloud): bit-equal to the CPU plain version, two calls equal; kernel "
                f"{t['ms']:.4f} ms (device {t['device_ms']:.4f} ms: {split_text(t['split'])}; "
                f"host {t['host_us']:.1f} us a call), plain (index_add_) {plain:.4f} ms, one "
                f"index_add_ of the terms {lib:.4f} ms, bound {bound:.4g} ms")
            del flat, src, acc
        log(f"scatter_rows {name} per step at B={b}: device {tally.device_ms:.4f} ms "
            f"({split_text(by_function)}), one index_add_ of the terms {tally.library_ms:.4f} "
            f"ms, bound {tally.bound_ms:.4g} ms")
        if edges:
            for what, kernel, plain_fn, args, entries in scatter_edge_cases(rng, dev, dt, shapes):
                t = scatter_timed(name, dt, what, kernel, plain_fn, args)
                tally.extra.setdefault("edges", []).append({"what": what, "entries": entries, **t})
                log(f"scatter_rows {name} {what} ({entries} entries a cloud): bit-equal to the "
                    f"CPU plain version, two calls equal; kernel {t['ms']:.4f} ms (device "
                    f"{t['device_ms']:.4f} ms: {split_text(t['split'])}; host "
                    f"{t['host_us']:.1f} us a call)")
        out[name] = tally
    return out


def cudnn_backward_cost(dev, shapes, b: int = TRAIN_B) -> dict:
    """K1's backward (the recomputed conv + GroupNorm and its gradient
    through cuDNN) at the convs of a training step of ``b`` clouds (bf16), with
    cuDNN's deterministic algorithms as the port runs it and without them,
    TF32 off in both: ms per step, and the deterministic gradient's bits
    equal over two calls. Beside the back-to-back times, the device time
    of the deterministic call from a trace: all its kernels (the recompute
    and the plain GroupNorm backward included), and cuDNN's alone, the
    group the profiled training step reports. Its bound: the dgrad and
    wgrad products (2 x 27 Cin Cout multiply-adds a voxel each) over the
    bf16 peak."""
    convs = []
    for _, r, cin, cout in shapes["pvconv"]:
        convs += [(r, cin, cout, True), (r, cout, cout, False)]
    gen = torch.Generator(device=dev).manual_seed(7)
    total = {True: 0.0, False: 0.0}
    device = {"all": 0.0, "cudnn": 0.0}
    ops = sum(calls * 2 * 2 * b * r ** 3 * 27 * cin * cout
              for (r, cin, cout, _), calls in counted(convs))
    bound = ops / PEAK_OPS_PER_S["bf16"] * 1e3
    for (r, cin, cout, act), calls in counted(convs):
        x, w, bias, gamma, beta = conv_inputs(gen, dev, torch.bfloat16, b, r, cin, cout, False)
        inputs = [t.requires_grad_() for t in (x, w, bias, gamma, beta)]
        g = torch.randn(b, r, r, r, cout, device=dev, generator=gen).bfloat16()

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
        groups = traced_device_ms(lambda: backward(True), f"K1 backward r={r} {cin}->{cout}")
        dev_ms = {"all": sum(groups.values()),
                  "cudnn": groups.get("cuDNN convolutions (K1's backward)", 0.0)}
        for k in device:
            device[k] += calls * dev_ms[k]
        log(f"K1 backward (cuDNN) bf16 r={r} {cin}->{cout} x{calls} B={b}: deterministic "
            f"{ms[True]:.3f} ms (two calls bit-equal; device {dev_ms['all']:.3f} ms, cuDNN's "
            f"{dev_ms['cudnn']:.3f}), default algorithms {ms[False]:.3f} ms")
        del x, inputs, g
        torch.cuda.empty_cache()
    log(f"K1 backward per training step: deterministic {total[True]:.2f} ms (device "
        f"{device['all']:.2f} ms, cuDNN's kernels {device['cudnn']:.2f}), default "
        f"{total[False]:.2f} ms; bound (dgrad + wgrad, {ops:.4g} operations) {bound:.4f} ms")
    return {"deterministic_ms": total[True], "default_ms": total[False],
            "deterministic_device_ms": device["all"], "cudnn_device_ms": device["cudnn"],
            "bound_ms": bound, "operations": ops}


def traced_device_ms(fn, what: str, calls: int = 3) -> dict:
    """Device ms of one call of ``fn`` by kernel group: ``calls`` calls
    traced after start_trace's spin kernels, through device_time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    start_trace(prof)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.stop()
    out = device_time(prof, wall_ms, what)
    return {g: ms / calls for g, ms in out["device_ms_by_group"].items()}


def aligned_batch(cfg: dict, dev) -> dict:
    """One training batch of the synthetic tree through the port's loader."""
    loader, _ = get_dataloader(cfg)
    try:
        batch = get_data_batch(next(iter(loader)), cfg)
    finally:
        loader.stop()
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if v is not None}


def auction_equal(what, got, want, again) -> None:
    """One K7 route's (dist, assign, stats) torch.equal to the plain
    version's (dist, assign) and to a second call's."""
    dist, assign, _ = got
    if not (torch.equal(assign, want[1]) and torch.equal(dist, want[0])):
        raise AssertionError(f"auction {what}: {(assign != want[1]).sum().item()} assignments "
                             "differ from the plain version")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"auction {what}: two calls differ")


def check_auction(batch: dict, dev) -> dict:
    """K7 on a real batch (noisy onto clean), as the alignment calls it
    (eps 0.01, 100 rounds), then with 3 and 1 rounds so that points are
    left to the greedy fallback: torch.equal to the plain version on
    pairwise_sqdist_ordered and to a second call. For information, the
    assignments that differ from the plain version on the matrix product's
    distances (pairwise_sqdist, the parent's route). Timed at 100 rounds,
    beside pairwise_sqdist alone (the matrix the parent's route built)."""
    x, y = batch["x_start"].contiguous(), batch["x_gt"].contiguous()
    d2_product = pairwise_sqdist(x, y)
    d2_ordered = pairwise_sqdist_ordered(x, y)
    B, N, M = d2_ordered.shape
    tally = Tally("f32", library=False)
    for iters in (100, 3, 1):
        got = emd_auction._auction_emd_cuda(x, y, 0.01, iters)
        auction_equal(f"{iters} rounds", got,
                      emd_auction.auction_emd_plain(d2_ordered, 0.01, iters),
                      emd_auction._auction_emd_cuda(x, y, 0.01, iters))
        torch.cuda.synchronize()
        st = got[2]
        rows, left = (int(v) for v in st[:, 1:].sum(0).tolist())
        stats = {"rounds_max": int(st[:, 0].max()), "bidder_rows": rows, "fallback_points": left}
        if iters < 100 and left == 0:
            raise AssertionError(f"auction {iters} rounds left no point to the fallback")
        moved = int((got[1] != emd_auction.auction_emd_plain(d2_product, 0.01, iters)[1]).sum())
        log(f"auction_emd B={B} N={N} M={M} eps 0.01 {iters} rounds: equal to the plain version "
            f"and to a second call; {json.dumps(stats)}; the ordered distances move {moved} of "
            f"{B * N} assignments against the matrix product's")
        tally.extra[f"rounds_{iters}"] = {**stats, "assignments_moved": moved}
        if iters == 100:
            def call():
                return emd_auction.auction_emd(x, y, 0.01, iters)

            ms = time_ms(call)
            dms = device_ms(call, "auction_emd")
            hus = host_us(call, ms)
            build_ms = time_ms(lambda: pairwise_sqdist(x, y))
            plain = time_ms(lambda: emd_auction.auction_emd_plain(
                pairwise_sqdist_ordered(x, y), 0.01, iters), runs=2)
            # coordinates read once, outputs written once; 11 f32 operations
            # a distance, for every value of every bidder and fallback row
            # and one distance a point for dist
            nbytes = B * (N + M) * 12 + B * N * 8
            bound = tally.add(1, ms, plain, None, nbytes, 11.0 * ((rows + left) * M + B * N), 0.0,
                              dms, hus)
            tally.extra["pairwise_sqdist_ms"] = build_ms
            log(f"auction_emd {ms:.4f} ms (device {dms:.4f} ms, host {hus:.1f} us a call), plain "
                f"{plain:.3f} ms, bound {bound:.4g} ms ({rows + left} row scans); "
                f"pairwise_sqdist alone {build_ms:.4f} ms ({B * N * M * 4 / 1e6:.0f} MB)")
    if DEVICE_LAUNCHES.get("auction_emd") != 1:
        raise AssertionError(f"auction_emd launched {DEVICE_LAUNCHES.get('auction_emd')} "
                             "device functions a call in its traces, not 1")
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


def train_gradient(model, bridge, batch: dict, align: bool = True) -> torch.Tensor:
    """One forward + backward of a training step as train_step runs it:
    the K7 alignment where ``align`` (PUNet), then the loss (conditioned on
    the batch's x_cond where it has one) with its timesteps and noise from a
    generator seeded here and dropout from the CUDA RNG, seeded here too."""
    generator = torch.Generator(batch["x_start"].device).manual_seed(11)
    torch.manual_seed(12)  # dropout: the CUDA RNG (and the CPU's)
    x_gt = batch["x_gt"]
    if align:
        x_gt = align_clean_to_noisy(batch["x_start"], x_gt, eps=0.01, iters=100)
    loss = bridge.loss_fn(x_gt, batch["x_start"], batch.get("x_cond"), generator=generator)
    loss.backward()
    return loss


def check_train_gradient_bits(cfg: dict, batch: dict, dev) -> dict:
    """The configuration's model as shipped (bf16, dropout; PVDS_PUNet at
    bs 32 x 2048 with the K7 alignment, PVDL_SNPP at bs 4 x 4096 with its
    384 feature channels): one forward + backward twice from the same
    weights and batch, every generator reseeded before each; every
    parameter's gradient must be torch.equal, and the error names the first
    that differs."""
    model = build_unet_from_config(cfg).train()
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(dev)
    bridge = P2PBridge.from_config(cfg, model)
    align = cfg["data"]["dataset"] == "PUNet"
    runs, losses = [], []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        losses.append(train_gradient(model, bridge, batch, align).item())
        runs.append([p.grad.clone() for p in model.parameters()])
    differ = first_differing(model, *runs)
    b, n, _ = batch["x_start"].shape
    cond = batch.get("x_cond")
    log(f"bf16 forward + backward at the training shape (bs {b} x {n}"
        f"{'' if cond is None else f', {cond.shape[-1]} feature channels'}, dropout "
        f"{cfg['model']['dropout']}{', K7 alignment' if align else ''}), twice from the same "
        f"weights and batch: losses {losses}; gradients "
        f"{'bit-equal in every parameter' if differ is None else f'differ first in {differ}'}")
    if differ is not None or losses[0] != losses[1]:
        raise AssertionError(f"two bf16 training-shape gradients differ, first in {differ}; "
                             f"losses {losses}")
    return {"bit_equal": True, "loss": losses[0], "batch": b}


def check_watch_step(cfg: dict, batch: dict, dev) -> dict:
    """A watch step (train_step with return_grads) and a plain step of
    PVDS_PUNet as shipped, each from the same initial weights, batch and
    reseeded generators: the clipped gradients, the parameters after the
    update, Adam's moments and the EMA torch.equal, and the gradients the
    watch step returns, times the clip factor, equal to the plain step's
    clipped ones."""
    runs = []
    for watch in (True, False):
        model = build_unet_from_config(cfg).train()
        init_parameters(model, torch.Generator().manual_seed(0))
        model.to(dev)
        state = init_train_state(model, cfg)
        torch.cuda.manual_seed(12)
        metrics = train_step(P2PBridge.from_config(cfg, model), state, batch,
                             torch.Generator(dev).manual_seed(11), grad_clip=1.0,
                             align_cfg={"eps": 0.01, "iters": 100}, return_grads=watch)
        runs.append((model, state, metrics))
    (wmodel, wstate, wm), (pmodel, pstate, pm) = runs
    clip = torch.clamp(1.0 / (wm["grad_norm"] + 1e-6), max=1.0)
    differ = [name for (name, a), b in zip(wmodel.named_parameters(), pmodel.parameters())
              if not (torch.equal(a, b) and torch.equal(a.grad, b.grad)
                      and torch.equal(wm["grads"][name] * clip, b.grad)
                      and all(torch.equal(wstate.optimizer.state[a][k],
                                          pstate.optimizer.state[b][k])
                              for k in ("exp_avg", "exp_avg_sq"))
                      and torch.equal(wstate.ema.params[name], pstate.ema.params[name]))]
    same = torch.equal(wm["loss"], pm["loss"]) and torch.equal(wm["grad_norm"], pm["grad_norm"])
    log(f"watch step (return_grads) against a plain step from the same state and generators: "
        f"{len(wm['grads'])} gradients returned, clip factor {clip.item():.4g}; gradients, "
        f"update, moments and EMA {'bit-equal' if same and not differ else 'differ'}")
    if differ or not same:
        raise AssertionError(f"a watch step differs from a plain step in {differ[:5]} "
                             f"(loss and norm equal: {same})")
    return {"bit_equal": True, "gradients": len(wm["grads"]), "clip": clip.item()}


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
    """The ``train`` observer: CUDA events and the host clock at every
    phase of steps 10-29, the launch counts of step 20, a profile of the
    last step, ``steps`` - 1 (and its launch counts), every loss. ``single``
    names the kernels of one device function a launch whose share of
    records in the profile is checked."""

    PHASES = ("begin", "batch", "align", "forward_backward", "update")

    def __init__(self, steps: int, what: str, single: tuple):
        from torch.profiler import ProfilerActivity, profile

        self.last, self.what, self.single = steps - 1, what, single
        self.events, self.host, self.losses, self.launches = {}, {}, [], None
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.profile = None
        self.t0 = 0.0

    def __call__(self, step, event, metrics):
        if event == "begin" and step in (20, self.last):
            if step == self.last:
                torch.cuda.synchronize()
                start_trace(self.prof)
            kernels.reset_launch_counts()
            self.t0 = time.perf_counter()
        if 10 <= step < 30 and event in self.PHASES:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.setdefault(step, {})[event] = e
            self.host.setdefault(step, {})[event] = time.perf_counter() * 1e3
        if event == "end":
            self.losses.append(metrics["loss"])
            if step == 20:
                self.launches = dict(kernels.launch_counts)
            if step == self.last:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - self.t0) * 1e3
                self.prof.stop()
                self.profile = device_time(self.prof, wall, self.what)
                self.profile["launches"] = dict(kernels.launch_counts)
                self.profile["recorded_share"] = recorded_share(
                    self.profile, kernels.launch_counts, self.single)


class EvalClock:
    """While entered, wraps the training loop's ``evaluate``: each call's
    host time (synchronised before and after), step and exception, which
    it passes on to the loop's guard."""

    def __init__(self):
        self.calls = []
        self.module = importlib.import_module("p2p_bridge_tpu_torch.train")
        self.inner = self.module.evaluate

    def __enter__(self):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call = {"step": args[3], "error": None}
            self.calls.append(call)
            try:
                return self.inner(*args, **kwargs)
            except Exception as e:
                call["error"] = f"{type(e).__name__}: {e}"
                raise
            finally:
                torch.cuda.synchronize()
                call["ms"] = (time.perf_counter() - t0) * 1e3

        self.module.evaluate = timed
        return self

    def __exit__(self, *exc):
        self.module.evaluate = self.inner


def check_train_outputs(cfg: dict, model, evals: list) -> dict:
    """What the loop wrote besides the checkpoint: metrics.jsonl with the
    losses and one evaluation's finite eval/* keys (CD, EMD, MSE and their
    noisy floors; the renderings where matplotlib imports, else the
    evaluation's ImportError is the only error allowed) and, where the
    configuration asks for them (phase 7), histograms.jsonl with a
    parameter row and a gradient row of every parameter at the watch step
    and the profile_dir trace of steps 10-14."""
    out = Path(cfg["output_dir"])
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    keys = [f"eval/{p}{k}" for p in ("", "noisy_") for k in ("CD", "EMD", "MSE")]
    scored = [r for r in recs if "eval/CD" in r]
    if not (len(evals) == 1 and evals[0]["step"] == VIZ_INTERVAL and len(scored) == 1
            and all(math.isfinite(scored[0].get(k, math.nan)) for k in keys)):
        raise AssertionError(f"in-training evaluation: calls {evals}, records {scored}")
    try:
        import matplotlib  # noqa: F401
        has_matplotlib = True
    except ImportError:
        has_matplotlib = False
    pngs = sorted(p.name for p in (out / "output").glob("*.png"))
    error = evals[0]["error"]
    if has_matplotlib:
        rendered = error is None and pngs == [f"{VIZ_INTERVAL:07d}_gt.png",
                                              f"{VIZ_INTERVAL:07d}_pred.png"]
    else:
        rendered = error is not None and "matplotlib" in error and not pngs
    if not rendered:
        raise AssertionError(f"evaluation renderings {pngs}, error {error}, matplotlib "
                             f"{has_matplotlib}")
    evaluation = {k: scored[0][k] for k in keys}
    log(f"in-training evaluation after step {VIZ_INTERVAL - 1}: {evals[0]['ms']:.0f} ms "
        f"(host clock), {json.dumps({k: round(v, 5) for k, v in evaluation.items()})}; "
        f"renderings {pngs if pngs else 'not drawn: ' + str(error)} (matplotlib "
        f"{'present' if has_matplotlib else 'absent'})")
    written = {"evaluation": evaluation, "evaluation_ms": evals[0]["ms"],
               "rendered": bool(pngs), "matplotlib": has_matplotlib}
    if not cfg.get("profile_dir"):
        return written
    names = {n for n, _ in model.named_parameters()}
    hists = [json.loads(x) for x in (out / "histograms.jsonl").read_text().splitlines()]
    rows = {next(iter(h["hists"])).split("/")[0]: h for h in hists}
    if not (len(hists) == 2 and set(rows) == {"param", "grad"}
            and all(h["step"] == WATCH_INTERVAL for h in hists)
            and all(set(h["hists"]) == {f"{p}/{n}" for n in names} for p, h in rows.items())):
        raise AssertionError(f"histograms.jsonl: {[(h['step'], len(h['hists'])) for h in hists]}"
                             f" rows, {len(names)} parameters")
    traces = sorted(p.name for p in Path(cfg["profile_dir"]).glob("*.json"))
    if traces != [f"trace_steps_{PROFILE_STEPS[0]}_{PROFILE_STEPS[1]}.json"]:
        raise AssertionError(f"profile_dir holds {traces}")
    log(f"histograms of {len(names)} parameters and their gradients at step {WATCH_INTERVAL}; "
        f"trace {traces[0]} "
        f"({(Path(cfg['profile_dir']) / traces[0]).stat().st_size / 1e6:.1f} MB)")
    return {**written, "histogram_parameters": len(names), "trace": traces[0]}


def train_phase(cfg: dict, dev) -> tuple:
    """``train`` on ``cfg`` (phase 7's PUNet or phase 10's ScanNet++
    configuration) through a TrainObserver: every loss finite and the last
    five below the first five, every kernel of the step launched in step 20
    (K7 only where PUNet's alignment runs), the ms of a step over steps
    10-29 by phase, patches/s; then check_train_outputs."""
    punet = cfg["data"]["dataset"] == "PUNet"
    required = TRAINING if punet else ROOM_TRAINING
    steps, bs = cfg["training"]["steps"], cfg["training"]["bs"]
    extra = cfg["model"].get("extra_feature_channels", 0)
    obs = TrainObserver(steps, f"one bf16 {'' if punet else 'room '}train step",
                        tuple(k for k in SINGLE_FUNCTION if k in required))
    t0 = time.perf_counter()
    with EvalClock() as evals:
        state = train(cfg, dev, observer=obs)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    losses = [float(v) for v in obs.losses]
    pool = cfg["data"].get("pool_size") if punet else None
    log(f"trained {steps} steps on {cfg['data']['dataset']} (bf16, bs {bs} x "
        f"{cfg['data']['npoints']}{f', {extra} feature channels' if extra else ''}, AdamW, clip "
        f"1.0, EMA{', K7 alignment' if punet else ''}) in {total_s:.1f} s"
        f"{f', data.pool_size cut to {pool}' if pool else ''}; "
        f"losses {[round(v, 5) for v in losses]}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (len(losses) == steps and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"training losses: {losses}")
    if not last < first:
        raise AssertionError(f"mean loss of the last five steps {last} >= first five {first}")
    idle = [k for k in required if obs.launches.get(k, 0) == 0]
    log(f"launches in step 20: {obs.launches}")
    if idle:
        raise AssertionError(f"kernels not launched in a training step: {idle}")
    spans = {"data": ("begin", "batch"), "align": ("batch", "align"),
             "forward_backward": ("align", "forward_backward"),
             "optimizer_ema": ("forward_backward", "update"), "step": ("begin", "update")}
    split = {name: float(np.median([ev[a].elapsed_time(ev[b]) for ev in obs.events.values()]))
             for name, (a, b) in spans.items()}
    host = {name: float(np.median([h[b] - h[a] for h in obs.host.values()]))
            for name, (a, b) in spans.items()}
    for clock, ms in (("CUDA events", split), ("host clock, as issued", host)):
        log(f"ms per step, median of steps 10-29 ({clock}): {ms['step']:.2f}; data "
            f"{ms['data']:.2f}, alignment {ms['align']:.2f}, forward + backward "
            f"{ms['forward_backward']:.2f}, optimizer + EMA {ms['optimizer_ema']:.2f}")
    # steps 10-14 run under profile_dir's profiler where it is set
    profiled = PROFILE_STEPS[1] if cfg.get("profile_dir") else -1
    unprofiled = float(np.median([ev["begin"].elapsed_time(ev["update"])
                                  for step, ev in obs.events.items() if step > profiled]))
    k7 = obs.profile["device_ms_by_group"].get("auction_emd", float("nan"))
    log(f"{bs / split['step'] * 1e3:.1f} patches/s; median of steps {max(profiled + 1, 10)}-29 "
        f"without profile_dir's profiler {unprofiled:.2f} ms"
        f"{f'; K7 in the step {steps - 1} profile: {k7:.4f} ms' if 'auction_emd' in required else ''}")
    written = check_train_outputs(cfg, state.model, evals.calls)
    return state, {"losses": losses, "first5_mean": first, "last5_mean": last,
                   "launches": obs.launches, "ms": split, "host_ms": host,
                   "step_ms_unprofiled_steps": unprofiled, "train_s": total_s,
                   "patches_per_s": bs / split["step"] * 1e3, "profile": obs.profile,
                   "loop_outputs": written}


def alignment_host_ms(model, batch: dict) -> dict:
    """Host ms of what a training step issues between its "batch" and
    "align" marks: ``model.train()`` (train_step calls it every step) and
    the alignment (K7 and the gather), each the median of 20 calls after
    a synchronise."""
    def clock(fn) -> float:
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return float(np.median(times))

    x, y = batch["x_start"], batch["x_gt"]
    out = {"model_train_ms": clock(model.train),
           "align_clean_to_noisy_ms": clock(lambda: align_clean_to_noisy(x, y, 0.01, 100))}
    log(f"host ms between the alignment span's marks: model.train() {out['model_train_ms']:.3f}, "
        f"align_clean_to_noisy issued {out['align_clean_to_noisy_ms']:.3f}")
    return out


def loaded_forwards_equal(state, cfg: dict, loaded_cfg: dict, path: str, load, batch: dict,
                          dev, what: str) -> None:
    """``load(model, path, use_ema)`` into models built from ``loaded_cfg``,
    with and without the EMA: every tensor equal to the trained one, and a
    bit-equal forward on the batch's first cloud (with its x_cond, if any)
    on the card."""
    x, c = batch["x_start"][:1], batch.get("x_cond")
    c = None if c is None else c[:1]
    t = torch.tensor([700.0], device=dev)
    trained = {True: state.ema.params, False: state.model.state_dict()}
    for use_ema, params in trained.items():
        ref = build_unet_from_config(cfg).eval()
        ref.load_state_dict({k: v.cpu() for k, v in params.items()})
        fresh = build_unet_from_config(loaded_cfg).eval()
        load(fresh, path, use_ema)
        same = all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                    ref.state_dict().values()))
        ref.to(dev)
        fresh.to(dev)
        with torch.no_grad():
            got, want = fresh(x, t, c), ref(x, t, c)
        if not (same and torch.equal(got, want)):
            raise AssertionError(f"{what} (use_ema={use_ema}): weights equal {same}, forward "
                                 f"differs by {(got - want).abs().max()}")
    log(f"{what}, with and without --use_ema: weights equal, forwards bit-equal (card, 1 x "
        f"{x.shape[1]})")


def check_checkpoint(state, cfg: dict, batch: dict, dev) -> dict:
    """save_checkpoint -> denoise_object.load_weights (loaded_forwards_equal)."""
    with tempfile.TemporaryDirectory() as tmp:
        loaded_forwards_equal(state, cfg, cfg, save_checkpoint(tmp, state),
                              denoise_object.load_weights, batch, dev,
                              "checkpoint round trip: save_checkpoint -> "
                              "denoise_object.load_weights")
    return {"bit_equal": True}


def training(dev, plan, root: Path) -> dict:
    """Phase 7, in ``root``: the trained run stays in root / "run"
    (model.pt) for phase 9."""
    shapes = main_path_shapes(plan, PATCH)
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
    gradient["watch_step"] = check_watch_step(cfg, batch, dev)
    audit = determinism_audit(cfg, batch, dev)
    torch.cuda.empty_cache()
    state, run = train_phase(cfg, dev)
    run["alignment_host_ms"] = alignment_host_ms(state.model, batch)
    checkpoint = check_checkpoint(state, cfg, batch, dev)
    return {"results": results, "gradient": gradient, "run": run, "checkpoint": checkpoint,
            "k1_backward_cudnn": cudnn, "determinism_audit": audit}


# ---------------------------------------------------------------- phase 8
ROOM_POINTS = 200_000  # scripts/make_synthetic_rooms.py's scan: points, sigma, outliers
ROOM_NOISE = 0.015
ROOM_OUTLIERS = 0.002
ROOM_FEATS = 384  # PVDL_SNPP's model.extra_feature_channels (DINO features)
ROOM_PATCH = 4096  # PVDL_SNPP's data.npoints
ROOM_BATCH = 32  # the room CLI's --batch_size
ROOM_STEPS = 5
ROOM_K = 4
# card vs CPU of one squared nearest-neighbour distance in the
# |a|^2 + |b|^2 - 2ab form (TF32 off): the two sum the three terms in other
# orders, a few ulps of the largest term apart
CD_ULPS = 4


def grid_surface(nu: int, nv: int, point) -> tuple:
    """The surface point(u, v), u and v in [0, 1], on an nu x nv grid of
    vertices -> (verts [nu * nv, 3], faces [2 (nu - 1)(nv - 1), 3])."""
    u, v = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv), indexing="ij")
    verts = np.stack(point(u, v), -1).reshape(-1, 3)
    a = (np.arange(nu - 1)[:, None] * nv + np.arange(nv - 1)[None, :]).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + nv], 1),
                            np.stack([a + 1, a + nv + 1, a + nv], 1)])
    return verts, faces


def room_mesh(rng) -> tuple:
    """A 4 x 4 m floor (5 cm grid) with two each of boxes, spheres and
    cylinders standing on it, 0.25-0.6 m in size, as
    scripts/make_synthetic_rooms.py builds its scenes."""
    parts = [grid_surface(81, 81, lambda u, v: (4 * u, 4 * v, 0 * u))]
    for i in range(6):
        cx, cy = rng.uniform(0.7, 3.3, 2)
        s = rng.uniform(0.25, 0.6)
        kind = ("box", "sphere", "cylinder")[i % 3]
        if kind == "sphere":
            parts.append(grid_surface(24, 48, lambda u, v: (
                cx + s * np.sin(np.pi * u) * np.cos(2 * np.pi * v),
                cy + s * np.sin(np.pi * u) * np.sin(2 * np.pi * v), s + s * np.cos(np.pi * u))))
        elif kind == "cylinder":
            parts.append(grid_surface(16, 48, lambda u, v: (
                cx + s * np.cos(2 * np.pi * v), cy + s * np.sin(2 * np.pi * v), 2 * s * u)))
        else:
            for face in (lambda u, v: (cx + s * (2 * u - 1), cy + s * (2 * v - 1), 0 * u + s),
                         lambda u, v: (0 * u + cx - s, cy + s * (2 * u - 1), s * v),
                         lambda u, v: (0 * u + cx + s, cy + s * (2 * u - 1), s * v),
                         lambda u, v: (cx + s * (2 * u - 1), 0 * u + cy - s, s * v),
                         lambda u, v: (cx + s * (2 * u - 1), 0 * u + cy + s, s * v)):
                parts.append(grid_surface(16, 16, face))
    verts, faces, off = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    return np.concatenate(verts), np.concatenate(faces)


def sample_mesh(verts, faces, n: int, rng) -> np.ndarray:
    """n points uniform over the mesh's area."""
    tri = verts[faces]
    areas = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    t = tri[rng.choice(len(faces), size=n, p=areas / areas.sum())]
    u, v = rng.uniform(size=(2, n, 1))
    flip = (u + v) > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    return t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])


def synthetic_room(root: Path, rng, scene: str = "scene0", points: int = ROOM_POINTS) -> tuple:
    """A ScanNet++ scene as the room CLIs read it: data/<scene>/scans/
    iphone.ply (``points`` points sampled from the mesh, gaussian noise
    and a fraction of outliers), scans/mesh_aligned_0.05.ply (the mesh,
    written with the port's write_ply) and features/dino_iphone.npy
    ([ROOM_FEATS, N] f32 from the seed, SNPP's layout). -> (scan path,
    data root)."""
    scene = root / "data" / scene
    (scene / "scans").mkdir(parents=True)
    (scene / "features").mkdir()
    verts, faces = room_mesh(rng)
    write_ply(str(scene / "scans" / "mesh_aligned_0.05.ply"), verts, faces=faces)
    noisy = sample_mesh(verts, faces, points, rng)
    noisy += rng.normal(size=noisy.shape) * ROOM_NOISE
    sel = rng.choice(points, int(ROOM_OUTLIERS * points), replace=False)
    noisy[sel] += rng.normal(size=(len(sel), 3)) * (10 * ROOM_NOISE)
    scan = scene / "scans" / "iphone.ply"
    write_ply(str(scan), noisy.astype(np.float32))
    np.save(scene / "features" / "dino_iphone.npy",
            rng.standard_normal((ROOM_FEATS, points), dtype=np.float32))
    log(f"synthetic room {scene.name}: {points:,} points, mesh of {len(verts):,} vertices and "
        f"{len(faces):,} faces, {ROOM_FEATS} feature channels")
    return scan, root / "data"


def build_room_models() -> tuple:
    """(PVDL_SNPP as shipped, computing in bf16, random weights from seed
    0; its f32 twin), on the CPU."""
    model = build_unet_from_config(pvdl_snpp()).eval()
    init_parameters(model, torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in model.parameters())
    if n != 118_666_115 or model.dtype != torch.bfloat16:
        raise AssertionError(f"PVDL_SNPP: {n} parameters in {model.dtype}, "
                             "expected 118,666,115 computing in bf16")
    cfg = pvdl_snpp()
    cfg["model"]["compute_dtype"] = "f32"
    twin = build_unet_from_config(cfg).eval()
    twin.load_state_dict(model.state_dict())
    log(f"PVDL_SNPP: {n:,} parameters, computing in bf16 as shipped; f32 twin")
    return model, twin


def room_inputs(scan: Path, b: int, dev) -> tuple:
    """b patches of ROOM_PATCH points of the scan (each normalised as
    denoise_patch_batch does), ROOM_FEATS feature channels from a seed and
    timesteps, on ``dev``."""
    rng = np.random.default_rng(7)
    pts = read_ply(str(scan))["points"]
    xyz = pts[rng.choice(len(pts), (b, ROOM_PATCH))]
    xyz = xyz - xyz.mean(axis=1, keepdims=True)
    xyz /= np.linalg.norm(xyz, axis=2).max(axis=1)[:, None, None]
    cond = rng.standard_normal((b, ROOM_PATCH, ROOM_FEATS), dtype=np.float32)
    t = rng.uniform(0.0, 1000.0, b).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                 for a in (xyz, t, cond))


def check_room_forward(model, twin, scan: Path, dev) -> dict:
    """The f32 forward on the card against the CPU at B = 1 with the
    conditioning (FORWARD_TOL) and the bf16 forward against the f32 one
    (BF16_FORWARD_REL_L2), as phase 4; two bf16 forwards at B = ROOM_BATCH
    bit-equal. Moves both models to the card."""
    x, t, c = room_inputs(scan, 1, "cpu")
    with torch.no_grad():
        want = twin(x, t, c).numpy()
        twin.to(dev)
        got32 = twin(x.to(dev), t.to(dev), c.to(dev)).cpu().numpy()
        got16 = model.to(dev)(x.to(dev), t.to(dev), c.to(dev)).cpu().numpy()
    err = float(np.abs(got32 - want).max())
    tol = FORWARD_TOL * max(1.0, float(np.abs(want).max()))
    rel = float(np.linalg.norm(got16 - got32) / np.linalg.norm(got32))
    log(f"PVDL_SNPP f32 forward [1, {ROOM_PATCH}, 3 + {ROOM_FEATS}] card vs CPU: max err "
        f"{err:.3g} (tol {tol:.3g}), max|out| {np.abs(want).max():.3g}; bf16 vs f32 on the card: "
        f"relative L2 {rel:.4g} (bound {BF16_FORWARD_REL_L2})")
    if not (np.isfinite(got32).all() and err <= tol):
        raise AssertionError(f"PVDL_SNPP card forward differs from the CPU's: {err} > {tol}")
    if not (np.isfinite(got16).all() and rel <= BF16_FORWARD_REL_L2):
        raise AssertionError(f"PVDL_SNPP bf16 forward: relative L2 {rel} > {BF16_FORWARD_REL_L2}")
    x, t, c = room_inputs(scan, ROOM_BATCH, dev)
    with torch.no_grad():
        first = model(x, t, c)
        second = model(x, t, c)
    if not (torch.equal(first, second) and torch.isfinite(first).all()):
        raise AssertionError(f"two bf16 PVDL_SNPP forwards at B={ROOM_BATCH} differ by up to "
                             f"{(first - second).abs().max().item()}")
    log(f"two bf16 forwards of PVDL_SNPP at B={ROOM_BATCH} x {ROOM_PATCH} with "
        f"{ROOM_FEATS} feature channels, same weights and inputs: bit-equal")
    return {"f32_card_vs_cpu_max_abs": err, "tol": tol, "bf16_vs_f32_rel_l2": rel,
            "bf16_bit_equal": True}


def check_room_conv(dev, shapes) -> dict:
    """K1 at each conv of one bf16 PVDL_SNPP forward at B = ROOM_BATCH
    (``shapes``): against its plain version (conv_bf16_bound), and timed
    beside the plain version and cuDNN conv + GroupNorm, with its bound;
    r = 8 512 -> 512 runs as two channel tiles."""
    convs = []
    for _, r, cin, cout in shapes["pvconv"]:
        convs += [(r, cin, cout, True), (r, cout, cout, False)]
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = torch.bfloat16
    tally, shapes, worst_ratio = Tally("bf16", library=True), [], 0.0
    for (r, cin, cout, act), calls in counted(convs):
        x, w, b, gamma, beta = conv_inputs(gen, dev, dt, ROOM_BATCH, r, cin, cout, False)
        err, ratio = conv_error("bf16", (x, w, b, gamma, beta), act, f"room r={r} {cin}->{cout}")
        worst_ratio = max(worst_ratio, ratio)
        ms = time_ms(lambda: conv_ops.conv3d_gn(x, w, b, gamma, beta, 8, 1e-5, act))
        plain = time_ms(lambda: conv_ops.conv3d_gn_plain(x, w, b, gamma, beta, 8, 1e-5, act))
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        wc = w.permute(4, 3, 0, 1, 2).contiguous()
        ga, be = gamma.to(dt)[:, :, None, None, None], beta.to(dt)[:, :, None, None, None]

        def library():
            y = F.group_norm(F.conv3d(xc, wc, b.to(dt), padding=1), 8, eps=1e-5) * ga + be
            return F.silu(y) if act else y

        lib = time_ms(library)
        flop = 2.0 * ROOM_BATCH * r ** 3 * 27 * cin * cout
        nbytes = (ROOM_BATCH * r ** 3 * (cin + cout) + 27 * cin * cout) * esize(dt)
        bound = tally.add(calls, ms, plain, lib, nbytes, flop, err)
        shapes.append({"r": r, "cin": cin, "cout": cout, "swish": act, "calls": calls, "ms": ms,
                       "plain_ms": plain, "library_ms": lib, "bound_ms": bound, "max_abs_err": err,
                       "max_ratio_to_bound": ratio})
        log(f"conv3d_gn bf16 room r={r} {cin}->{cout}{' + swish' if act else ''} x{calls} "
            f"B={ROOM_BATCH}: max err {err:.3g} "
            f"({ratio:.3f} of its bound); kernel {ms:.3f} ms ({flop / ms / 1e9:.2f} TFLOP/s, "
            f"{bound / ms:.3f} of the bound {bound:.3g} ms), plain {plain:.3f} ms, cuDNN conv + "
            f"GroupNorm {lib:.3f} ms (kernel / cuDNN {ms / lib:.3f})")
        del x, xc
        torch.cuda.empty_cache()
    row = tally.row()
    log(f"conv3d_gn bf16 over one PVDL_SNPP forward at B={ROOM_BATCH}: kernel {row['ms']:.3f} ms, "
        f"plain {row['plain_ms']:.3f}, cuDNN {row['library_ms']:.3f}, bound {row['bound_ms']:.3f} "
        f"({row['bound_by']})")
    return {"per_forward": {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                "bound_by")}, "max_abs_err": tally.err,
            "max_ratio_to_bound": worst_ratio, "shapes": shapes}


def check_room_kernels(dev, shapes) -> dict:
    """Phase 3's comparisons at the shapes of one PVDL_SNPP forward at
    B = ROOM_BATCH (``shapes``: main_path_shapes of its plan at ROOM_PATCH),
    in bf16 and f32: K5 indices torch.equal on random and tied clouds; K4's
    rows and fused entries torch.equal to theirs; K2 grid and counts
    torch.equal to the CPU plain version; K3 within DEVOX_TOL with the mean
    torch.equal to the fixed order; K6 indices torch.equal, the sum within
    INTERP_TOL; K1 f32 within CONV_TOL (bf16: check_room_conv). -> the
    largest error of each kernel and dtype."""
    rng = np.random.default_rng(10)
    gen = torch.Generator(device=dev).manual_seed(11)
    B = ROOM_BATCH
    errs = {name: {} for name in SERVING}
    errs["fps"]["f32"] = 0.0  # indices, exact
    for i, (n, m, _, _, _) in enumerate(shapes["sa"]):
        fps_equal(patches(rng, B, n, dev), m, f"room sa{i} [{B}, {n}]")
        tied = torch.from_numpy(np.stack([tied_cloud(rng, n, 32) for _ in range(B)])).to(dev)
        fps_equal(tied, m, f"room sa{i} tied [{B}, {n}]")
        log(f"fps room sa{i} [{B}, {n}] -> {m}, random and tied: indices equal")
    for name, dt in DTYPES.items():
        for n, m, radius, k, c in shapes["sa"]:
            ball_query_equal(rng, dev, name, dt, B, n, m, radius, k, c)
            log(f"ball_query_group {name} room B={B} {n}->{m} r={radius} K={k} C={c}: idx, "
                "rows and the fused grouping equal")
        errs["ball_query_group"][name] = errs["avg_voxelize"][name] = 0.0  # exact
        for n, r, c in dict.fromkeys((n, r, cin) for n, r, cin, _ in shapes["pvconv"]):
            voxelize_equal(rng, dev, dt, B, n, r, c)
            log(f"avg_voxelize {name} room B={B} N={n} r={r} C={c}: grid and counts equal to "
                "the CPU plain version, two calls equal")
        worst = 0.0
        for n, r, c in dict.fromkeys((n, r, cout) for n, r, _, cout in shapes["pvconv"]):
            *_, err, tol, _ = devoxelize_equal(rng, dev, name, dt, B, n, r, c)
            worst = max(worst, err)
            log(f"trilinear_devoxelize {name} room B={B} N={n} r={r} C={c}: max err {err:.3g} "
                f"(tol {tol:.3g}), mean bit-equal to the fixed order, two calls bit-equal")
            torch.cuda.empty_cache()
        errs["trilinear_devoxelize"][name] = worst
        worst = 0.0
        for n, m, c in shapes["fp"]:
            pts = patches(rng, B, n, dev)
            centers = pts[:, :m].contiguous()
            feat = torch.randn(B, m, c, device=dev, generator=gen).to(dt)
            err_w, err = interp_equal(f"room B={B} {n}<-{m}", dt, pts, centers, feat)
            worst = max(worst, err, err_w)
            log(f"three_nn_interpolate {name} room B={B} {n}<-{m} C={c}: indices equal, "
                f"weights {err_w:.3g}, max err {err:.3g}")
        errs["three_nn_interpolate"][name] = worst
    convs = []
    for _, r, cin, cout in shapes["pvconv"]:
        convs += [(r, cin, cout, True), (r, cout, cout, False)]
    worst = 0.0
    for r, cin, cout, act in dict.fromkeys(convs):
        args = conv_inputs(gen, dev, torch.float32, B, r, cin, cout, False)
        err, ratio = conv_error("f32", args, act, f"room B={B} r={r} {cin}->{cout}")
        worst = max(worst, err)
        log(f"conv3d_gn f32 room B={B} r={r} {cin}->{cout}{' + swish' if act else ''}: "
            f"max err {err:.3g} ({ratio:.3f} of its bound)")
        del args
        torch.cuda.empty_cache()
    errs["conv3d_gn"]["f32"] = worst
    return errs


class RoomClock:
    """Clocks the phases of the room CLI's run by wrapping, while it is
    entered, the functions of rooms.py that denoise_room calls: the whole
    denoise_room (host clock), create_patches, each denoise_patch_batch
    (CUDA events and the host clock) and the recomposition (RunningMean's
    update and result). Keeps the patches and the bridge of the run."""

    def __init__(self):
        self.ms = {"denoise_room": 0.0, "create_patches": 0.0, "sampling": 0.0,
                   "recomposition": 0.0, "before_first_batch": None}
        self.batch_ms, self.patches, self.bridge, self.t0 = [], None, None, 0.0
        self.saved = []

    def _wrap(self, owner, name, wrapper):
        fn = getattr(owner, name)
        self.saved.append((owner, name, fn))
        setattr(owner, name, wrapper(fn))

    def __enter__(self):
        def timed(key):
            def wrapper(fn):
                def call(*args, **kw):
                    t0 = time.perf_counter()
                    out = fn(*args, **kw)
                    self.ms[key] += (time.perf_counter() - t0) * 1e3
                    if key == "create_patches":
                        self.patches = out
                    return out
                return call
            return wrapper

        def room(fn):
            def call(*args, **kw):
                self.t0 = time.perf_counter()
                return timed("denoise_room")(fn)(*args, **kw)
            return call

        def batch(fn):
            def call(bridge, *args, **kw):
                if self.ms["before_first_batch"] is None:
                    self.ms["before_first_batch"] = (time.perf_counter() - self.t0) * 1e3
                self.bridge = bridge
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                out = timed("sampling")(fn)(bridge, *args, **kw)
                end.record()
                torch.cuda.synchronize()
                self.batch_ms.append(start.elapsed_time(end))
                return out
            return call

        self._wrap(room_cli, "denoise_room", room)
        self._wrap(rooms, "create_patches", timed("create_patches"))
        self._wrap(rooms, "denoise_patch_batch", batch)
        self._wrap(rooms.RunningMean, "update", timed("recomposition"))
        self._wrap(rooms.RunningMean, "result", timed("recomposition"))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.saved = []


def denoise_room_cli(scan: Path, run: Path) -> tuple:
    """One run of python -m p2p_bridge_tpu_torch.denoise_room on the card
    (through main) with the launch counts set to 0 just before it and read
    just after -> (prediction [N, 3], launches, RoomClock, CLI wall ms)."""
    argv = ["--room_path", str(scan), "--model_path", str(run), "--steps", str(ROOM_STEPS),
            "--k", str(ROOM_K), "--batch_size", str(ROOM_BATCH), "--device", "cuda",
            "--overwrite"]
    with RoomClock() as clock:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = room_cli.main(argv)
        wall = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.launch_counts)
    return read_ply(out)["points"], launches, clock, wall


def profile_room_batch(clock: RoomClock, scan: Path, dev) -> dict:
    """torch.profiler over one more batch of ROOM_BATCH patches of the run
    (ROOM_STEPS steps), conditioned as denoise_room conditions it (the
    scan's features on the card, the batch's rows gathered there): device
    time by kernel group, the idle share and the launches of the batch."""
    from torch.profiler import ProfilerActivity, profile

    xyz, idxs = clock.patches[0], clock.patches[3]
    feats = np.load(scan.parent.parent / "features" / "dino_iphone.npy").T
    cond = (rooms.RoomConditioning(dev, feats), idxs[:ROOM_BATCH])
    sel = slice(0, ROOM_BATCH)

    def batch():
        rooms.denoise_patch_batch(clock.bridge, xyz[sel], ROOM_STEPS, cond=cond)

    batch()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start_trace(prof)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    batch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.stop()
    out = device_time(prof, wall_ms, f"bf16 room batch ({ROOM_BATCH} x {ROOM_PATCH}, "
                                     f"{ROOM_STEPS} steps)")
    out["launches"] = dict(kernels.launch_counts)
    out["recorded_share"] = recorded_share(
        out, kernels.launch_counts,
        ("trilinear_devoxelize", "ball_query_group", "three_nn_interpolate"))
    return out


def evaluate_room(data_root: Path, pred: np.ndarray, mesh_path: Path) -> dict:
    """python -m p2p_bridge_tpu_torch.evaluate_rooms on the card (through
    main), SNPP layout: the four metrics finite; the room's Chamfer
    distances on the card against the CPU, within CD_ULPS ulps of the
    largest term of a distance."""
    t0 = time.perf_counter()
    evaluate_rooms.main(["--data_root", str(data_root), "--dataset", "snpp", "--device", "cuda"])
    wall = (time.perf_counter() - t0) * 1e3
    (csv_path,) = data_root.glob("*/predictions/P2SB/metrics.csv")
    with open(csv_path, newline="") as f:
        (row,) = list(csv.DictReader(f))
    metrics = {k: float(row[k]) for k in ("point_dist", "face_dist", "cd_pred_gt", "cd_gt_pred")}
    log(f"evaluate_rooms (snpp, card) in {wall:.0f} ms: {metrics} (x 10^3)")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"room metrics not finite: {metrics}")
    gt = read_ply(str(mesh_path))["points"]
    card = chamfer_distance_large(pred, gt, device="cuda")
    cpu = chamfer_distance_large(pred, gt, device="cpu")
    tol = CD_ULPS * 2.0 ** -23 * float((pred ** 2).sum(1).max() + (gt ** 2).sum(1).max())
    err = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
    means = [float(d.mean()) for d in card + cpu]
    log(f"room Chamfer distance, card vs CPU: max abs {err:.3g} a squared distance (tol "
        f"{tol:.3g}); means card {means[0]:.6g} / {means[1]:.6g}, CPU {means[2]:.6g} / "
        f"{means[3]:.6g}")
    if not err <= tol:
        raise AssertionError(f"room Chamfer distance, card vs CPU: {err} > {tol}")
    return {"metrics_x1e3": metrics, "wall_ms": wall, "cd_card_vs_cpu_max_abs": err,
            "cd_tol": tol}


def room(dev) -> dict:
    """Phase 8: the room path of PVDL_SNPP at full width, through its CLIs."""
    if runtime.get_lib() is None:
        raise AssertionError("the native host runtime did not build (g++): the room path "
                             "would run on the numpy fallback")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        scan, data_root = synthetic_room(root, np.random.default_rng(8))
        model, twin = build_room_models()
        run = root / "runs" / "PVDL_SNPP"
        run.mkdir(parents=True)
        shutil.copy(Path(__file__).resolve().parent / "configs" / "PVDL_SNPP.yaml",
                    run / "opt.yaml")
        torch.save({"model": model.state_dict(), "ema": None}, run / "model.pt")
        log(f"room scene and run directory written in {time.perf_counter() - t0:.1f} s")
        forward = check_room_forward(model, twin, scan, dev)
        del model, twin
        torch.cuda.empty_cache()
        with torch.device("meta"):
            shapes = main_path_shapes(build_unet_from_config(pvdl_snpp()).plan, ROOM_PATCH)
        log(f"room path shapes at B={ROOM_BATCH}: {json.dumps(shapes)}")
        conv = check_room_conv(dev, shapes)
        kernel_errs = check_room_kernels(dev, shapes)
        kernel_errs["conv3d_gn"]["bf16"] = conv["max_abs_err"]

        first, launches, clock, wall = denoise_room_cli(scan, run)
        idle = [k for k in SERVING if launches.get(k, 0) == 0]
        log(f"denoise_room launches: {launches}")
        if idle:
            raise AssertionError(f"kernels not launched on the room path: {idle}")
        if not (first.shape == (ROOM_POINTS, 3) and np.isfinite(first).all()):
            raise AssertionError(f"room prediction: {first.shape}, finite "
                                 f"{np.isfinite(first).all()}")
        second, _, again, _ = denoise_room_cli(scan, run)
        if not np.array_equal(first, second):
            raise AssertionError("two runs of the room CLI differ by up to "
                                 f"{np.abs(first - second).max()}")
        idxs = clock.patches[3]
        n_patches, dup = len(idxs), len(idxs) - len(np.unique(idxs, axis=0))
        ms = clock.ms
        split = {"seeding_kdtree": ms["before_first_batch"] - ms["create_patches"],
                 "patching": ms["create_patches"], "sampling": ms["sampling"],
                 "recomposition": ms["recomposition"]}
        split["other"] = ms["denoise_room"] - sum(split.values())
        log(f"room: {n_patches} patches of {ROOM_PATCH} ({dup} duplicates of the FPS split), "
            f"{len(clock.batch_ms)} batches of {ROOM_BATCH}, {ROOM_STEPS} steps; ms per batch "
            f"(CUDA events) median {np.median(clock.batch_ms):.1f}, min {min(clock.batch_ms):.1f}, "
            f"max {max(clock.batch_ms):.1f}; denoise_room {ms['denoise_room']:.0f} ms "
            f"({ROOM_POINTS / ms['denoise_room'] * 1e3:.0f} points/s), the CLI {wall:.0f} ms; "
            f"host split (ms) {({k: round(v, 1) for k, v in split.items()})}; second run: "
            f"denoise_room {again.ms['denoise_room']:.0f} ms, batch median "
            f"{np.median(again.batch_ms):.1f}; two runs bit-equal")
        profile = profile_room_batch(clock, scan, dev)
        evaluation = evaluate_room(data_root, first, scan.parent / "mesh_aligned_0.05.ply")
    return {"forward": forward, "conv3d_gn": conv, "kernel_max_abs_err": kernel_errs,
            "launches": launches, "patches": n_patches,
            "duplicate_patches": dup, "batches": len(clock.batch_ms),
            "batch_ms": clock.batch_ms, "batch_ms_second_run": again.batch_ms,
            "denoise_room_ms": [ms["denoise_room"], again.ms["denoise_room"]],
            "points_per_s": [ROOM_POINTS / m["denoise_room"] * 1e3 for m in (ms, again.ms)],
            "cli_ms": wall, "host_split_ms": split, "profile_batch": profile,
            "bit_equal_runs": True, "evaluation": evaluation}


# ---------------------------------------------------------------- phase 10
ROOM_TRAIN_B = 4  # PVDL_SNPP's training.bs
# the validation scene: at 50,000 points every sphere of radius 0.3 holds
# fewer than 4096 mesh samples (5 x the scan's density), and
# preprocess_batches skips all of them
ROOM_VAL_POINTS = 100_000
ROOM_RADIUS = 0.3  # preprocess_batches' --r


def room_train_config(data_dir: Path, splits: Path, out_dir: Path) -> dict:
    """PVDL_SNPP as shipped on the preprocessed batches, for TRAIN_STEPS
    steps with one evaluation (VIZ_INTERVAL)."""
    cfg = pvdl_snpp()
    cfg["data"]["data_dir"] = str(data_dir)
    cfg["data"]["splits_path"] = str(splits)
    cfg["training"]["steps"] = TRAIN_STEPS
    cfg["training"]["viz_interval"] = VIZ_INTERVAL
    cfg["output_dir"] = str(out_dir)
    cfg["use_wandb"] = False  # the files only: wandb.init reaches wandb's servers
    return cfg


def room_batches(root: Path) -> dict:
    """The two synthetic scenes (train0: ROOM_POINTS, val0: ROOM_VAL_POINTS)
    through python -m p2p_bridge_tpu_torch.preprocess_batches (its main,
    two worker processes, --feature_type dino) and the split files; every
    batch file of 4096 paired points with 384 fp16 feature channels."""
    t0 = time.perf_counter()
    synthetic_room(root, np.random.default_rng(10), "train0")
    synthetic_room(root, np.random.default_rng(11), "val0", ROOM_VAL_POINTS)
    splits = root / "splits"
    splits.mkdir()
    (splits / "snpp_train.txt").write_text("train0\n")
    (splits / "snpp_val.txt").write_text("val0\n")
    scenes_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    preprocess_batches.main(["--data_root", str(root / "data"), "--output_root",
                             str(root / "batches"), "--npoints", str(ROOM_PATCH), "--r",
                             str(ROOM_RADIUS), "--feature_type", "dino", "--workers", "2"])
    seconds = time.perf_counter() - t0
    files = {s: sorted((root / "batches" / s).glob("points_*.npz")) for s in ("train0", "val0")}
    for path in files["train0"][:1] + files["val0"][:1]:
        with np.load(path) as d:
            shapes = {k: (d[k].shape, str(d[k].dtype)) for k in d.files}
        if not (shapes["noisy"][0] == shapes["clean"][0] == (ROOM_PATCH, 6)
                and shapes["features"] == ((ROOM_PATCH, ROOM_FEATS), "float16")):
            raise AssertionError(f"{path}: {shapes}")
    counts = {s: len(f) for s, f in files.items()}
    log(f"preprocess_batches (npoints {ROOM_PATCH}, r {ROOM_RADIUS}, dino features, 2 workers): "
        f"{counts} batches in {seconds:.1f} s (scenes written in {scenes_s:.1f} s); each "
        f"[{ROOM_PATCH}, 6] clean and noisy, [{ROOM_PATCH}, {ROOM_FEATS}] float16 features")
    if counts["train0"] < 4 * ROOM_TRAIN_B or counts["val0"] == 0:
        raise AssertionError(f"preprocess_batches wrote {counts} batches")
    return {"batches": counts, "seconds": seconds, "scenes_s": scenes_s,
            "splits": splits, "val_scan": root / "data" / "val0" / "scans" / "iphone.ply"}


def room_train_batch(cfg: dict, dev) -> dict:
    """The first ROOM_TRAIN_B items of the training set as one batch
    (get_data_batch: x_gt, x_start and x_cond), on ``dev``."""
    loader, _ = get_dataloader(cfg)
    items = [loader.dataset[i] for i in range(ROOM_TRAIN_B)]
    batch = get_data_batch({k: np.stack([it[k] for it in items])
                            for k in ("clean_points", "noisy_points", "noisy_features")}, cfg)
    if batch["x_cond"] is None or batch["x_cond"].shape != (ROOM_TRAIN_B, ROOM_PATCH, ROOM_FEATS):
        raise AssertionError("the room batch carries no 384-channel x_cond")
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def check_room_checkpoint(state, cfg: dict, batch: dict, val_scan: Path, dev) -> dict:
    """The run directory the loop wrote (model.pt, and opt.yaml through
    the training CLI's write_run_config) through denoise_room's loader
    (load_config, load_weights; loaded_forwards_equal); then python -m
    p2p_bridge_tpu_torch.denoise_room (through main) reads the run
    directory and denoises the validation scan."""
    run = Path(cfg["output_dir"])
    write_run_config(cfg)
    loaded_forwards_equal(state, cfg, room_cli.load_config(str(run), []), str(run),
                          room_cli.load_weights, batch, dev,
                          "room checkpoint: the loop's model.pt and opt.yaml through "
                          "denoise_room's loader")
    t0 = time.perf_counter()
    out = room_cli.main(["--room_path", str(val_scan), "--model_path", str(run), "--steps", "2",
                         "--k", "1", "--batch_size", str(ROOM_BATCH), "--device", "cuda",
                         "--out_path", str(run / "val0_denoised.ply")])
    wall = (time.perf_counter() - t0) * 1e3
    pred = read_ply(out)["points"]
    if not (pred.shape == (ROOM_VAL_POINTS, 3) and np.isfinite(pred).all()):
        raise AssertionError(f"denoise_room with the trained run: {pred.shape}, finite "
                             f"{np.isfinite(pred).all()}")
    log(f"denoise_room (2 steps, k 1) on the {ROOM_VAL_POINTS:,}-point validation scan with "
        f"the trained run directory in {wall:.0f} ms: finite")
    return {"bit_equal": True, "denoise_room_ms": wall}


def room_training(dev, root: Path) -> dict:
    """Phase 10: PVDL_SNPP trained at full width on preprocess_batches'
    output, with its backward kernels held at the room training shapes."""
    t_phase = time.perf_counter()
    data = room_batches(root)
    cfg = room_train_config(root / "batches", data["splits"], root / "room_run")
    with torch.device("meta"):
        shapes = main_path_shapes(build_unet_from_config(pvdl_snpp()).plan, ROOM_PATCH)
    log(f"room training shapes at B={ROOM_TRAIN_B}: {json.dumps(shapes)}")
    results = {"avg_voxelize_backward": check_voxelize_backward(
        np.random.default_rng(12), dev, shapes, ROOM_TRAIN_B),
        "scatter_rows": check_scatter(np.random.default_rng(13), dev, shapes, ROOM_TRAIN_B,
                                      edges=True)}
    for dt, tally in results["scatter_rows"].items():
        at_old = tally.extra.get("at_old_limit", [])
        past = [f"{e['what']}: {e['entries']} entries" for e in tally.extra.get("edges", [])]
        if not (any(a.startswith("K3") and "32768 entries, 32768 rows" in a for a in at_old)
                and any(a.startswith("K4") and "32768 entries" in a for a in at_old)
                and any(a.startswith("K3") and "65536 entries" in a for a in past)
                and any(a.startswith("K3") and f"{scatter_ops.MAX_ENTRIES} entries" in a
                        for a in past)):
            raise AssertionError(f"scatter_rows {dt}: the calls at the old limit (2^15), past "
                                 f"it and at the new limit were not all checked: {at_old}, "
                                 f"{past}")
    cudnn = cudnn_backward_cost(dev, shapes, ROOM_TRAIN_B)
    batch = room_train_batch(cfg, dev)
    bits = check_train_gradient_bits(cfg, batch, dev)
    torch.cuda.empty_cache()
    state, run = train_phase(cfg, dev)
    n = sum(p.numel() for p in state.model.parameters())
    if n != 118_666_115 or state.model.dtype != torch.bfloat16:
        raise AssertionError(f"PVDL_SNPP trained with {n} parameters in {state.model.dtype}")
    checkpoint = check_room_checkpoint(state, cfg, batch, data["val_scan"], dev)
    seconds = time.perf_counter() - t_phase
    log(f"phase 10: {seconds:.1f} s")
    return {"results": results, "preprocess": {k: v for k, v in data.items()
                                               if k in ("batches", "seconds", "scenes_s")},
            "gradient_bits": bits, "k1_backward_cudnn": cudnn, "run": run,
            "checkpoint": checkpoint, "parameters": n, "seconds": seconds}


# ---------------------------------------------------------------- phase 9
EVAL_EPS, EVAL_ROUNDS = 0.001, 10000  # the object Evaluator's auction
OBJECT_CELLS = [f"{res}_{noise}" for res in ("10000_poisson", "50000_poisson")
                for noise in ("0.01", "0.02", "0.03")]  # the CLI's defaults
OBJECT_METRICS = ("cd_sph", "p2f", "emd_sub", "emd_exact_sub")
# the approximate EMD, card against CPU: its rounds amplify the last bit of
# d2 and of each sum (one ulp of one cloud moves it by up to 4.4e-3
# relative; tests/test_torch_emd_approx.py); Chamfer to 1e-5 relative
# (tests/test_torch_room_metrics.py)
EMD_CARD_REL = 1e-2
CD_CARD_REL = 1e-5


class ObjectClock:
    """While entered, wraps what ``evaluate_objects.main`` calls: a cell's
    ``input_iter`` (which starts the cell), ``patch_based_denoise`` and the
    Evaluator's metric functions, each timed by the host clock between two
    synchronises and summed per cell."""

    TIMED = {"denoise": (evaluate_objects, "patch_based_denoise"),
             "cd": (object_evaluation, "chamfer_distance_unit_sphere"),
             "p2m": (object_evaluation, "point_mesh_bidir_distance_single_unit_sphere"),
             "emd_sub": (object_evaluation, "calculate_emd"),
             "emd_exact_sub": (object_evaluation, "calculate_emd_exact")}

    def __init__(self):
        self.cell, self.ms = None, {}
        self.saved = []  # (module, name, the function wrapped)

    def __enter__(self):
        inner_iter = evaluate_objects.input_iter

        def cell_iter(in_dir):
            self.cell = Path(in_dir).name
            self.ms[self.cell] = dict.fromkeys(self.TIMED, 0.0)
            return inner_iter(in_dir)

        self.saved.append((evaluate_objects, "input_iter", inner_iter))
        evaluate_objects.input_iter = cell_iter
        for key, (module, name) in self.TIMED.items():
            inner = getattr(module, name)
            self.saved.append((module, name, inner))

            def timed(*args, key=key, inner=inner, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(*args, **kwargs)
                torch.cuda.synchronize()
                self.ms[self.cell][key] += (time.perf_counter() - t0) * 1e3
                return out

            setattr(module, name, timed)
        return self

    def __exit__(self, *exc):
        for module, name, inner in self.saved:
            setattr(module, name, inner)


def read_summary(path: Path) -> dict:
    """Summary_<dataset>.csv -> {row: {metric without "(mean)": value}}."""
    _, _, rows = summary_csv(str(path))
    return {name: {c.replace("(mean)", ""): v for c, v in row.items()}
            for name, row in rows.items()}


def evaluate_objects_cli(run: Path, data: Path, out_root: Path, mode: str) -> tuple:
    """python -m p2p_bridge_tpu_torch.evaluate_objects through its main on
    the card (5 steps, ``mode`` recombination, the 6 cells) with the launch
    counts set to 0 just before and read just after -> (per-cell metrics,
    launches, per-cell ms, wall ms)."""
    argv = ["--model_path", str(run), "--dataset_root", str(data), "--output_root",
            str(out_root), "--steps", "5", "--recombine", mode]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with ObjectClock() as clock:
        summary = evaluate_objects.main(argv)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launch_counts)
    rows = read_summary(Path(summary))
    want = {f"PUNet_{cell}_steps5" for cell in OBJECT_CELLS}
    if not (set(rows) == want and all(
            set(r) == set(OBJECT_METRICS) and all(math.isfinite(v) for v in r.values())
            for r in rows.values())):
        raise AssertionError(f"Summary_PUNet.csv ({mode}): {rows}")
    idle = [k for k in SERVING + ("fps_cluster", "auction_emd") if launches.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"kernels not launched by evaluate_objects ({mode}): {idle}")
    metrics = {cell: rows[f"PUNet_{cell}_steps5"] for cell in OBJECT_CELLS}
    return metrics, launches, clock.ms, wall


def noisy_floor(data: Path, out_root: Path, dev) -> dict:
    """The Evaluator on each cell's noisy inputs themselves."""
    floor = {}
    for cell in OBJECT_CELLS:
        object_evaluation.Evaluator(
            str(data / "PUNet" / "pointclouds" / "test" / cell), str(data), "PUNet",
            str(out_root), f"noisy_{cell}", device=dev).run()
    rows = read_summary(out_root / "Summary_PUNet.csv")
    for cell in OBJECT_CELLS:
        floor[cell] = rows[f"noisy_{cell}"]
    return floor


def check_auction_eval_setting(data: Path, out_dir: Path, dev) -> dict:
    """K7 at the Evaluator's setting (eps 0.001, 10,000 rounds, B = 1) on
    the normalised 2048-point sub-samples of one shape, drawn as the
    Evaluator draws them: torch.equal to the plain version on
    pairwise_sqdist_ordered and to a second call, one device function a
    call, its rounds, times and bound."""
    name = sorted(out_dir.glob("*.xyz"))[0].stem
    pcl = read_xyz(str(out_dir / f"{name}.xyz"))[:, :3]
    gt = read_xyz(str(data / "PUNet" / "pointclouds" / "test" / "8192_poisson" / f"{name}.xyz"))
    rng = np.random.default_rng(abs(hash(name)) % (2**32))
    k = object_evaluation.EMD_POINTS
    sub_p = pcl[rng.choice(len(pcl), k, replace=False)][None]
    sub_g = gt[rng.choice(len(gt), k, replace=len(gt) < k)][None]
    ref, center, scale = obj_metrics.normalize_sphere(torch.as_tensor(sub_g, device=dev))
    gen = obj_metrics.normalize_pcl(torch.as_tensor(sub_p, device=dev), center, scale)
    x, y = gen.contiguous(), ref.contiguous()

    def call():
        return emd_auction._auction_emd_cuda(x, y, EVAL_EPS, EVAL_ROUNDS)

    def plain():
        return emd_auction.auction_emd_plain(pairwise_sqdist_ordered(x, y), EVAL_EPS, EVAL_ROUNDS)

    got = call()
    auction_equal(f"eps {EVAL_EPS} {EVAL_ROUNDS} rounds", got, plain(), call())
    torch.cuda.synchronize()
    rounds, rows, left = (int(v) for v in got[2][0].tolist())
    ms = time_ms(call)
    dms = device_ms(call, "auction_emd")
    if DEVICE_LAUNCHES.get("auction_emd") != 1:
        raise AssertionError("auction_emd at the evaluation setting launched "
                             f"{DEVICE_LAUNCHES.get('auction_emd')} device functions a call")
    hus = host_us(call, ms)
    plain_ms = time_ms(plain, runs=2)
    tally = Tally("f32", library=False)
    # as check_auction counts it: the coordinates read once, the outputs
    # written once; 11 f32 operations a distance of every bidder and
    # fallback row scanned, and one a point for dist
    bound = tally.add(1, ms, plain_ms, None, (k + k) * 12 + k * 8,
                      11.0 * ((rows + left) * k + k), 0.0, dms, hus)
    value = float(got[0].mean().sqrt()) * 1000.0
    log(f"auction_emd at the evaluation setting (B=1, N=M={k}, eps {EVAL_EPS}, "
        f"{EVAL_ROUNDS} rounds, shape {name}): equal to the plain version and to a second call; "
        f"{rounds} rounds, {rows} bidder rows, {left} points to the fallback; {ms:.4f} ms "
        f"(device {dms:.4f} ms, host {hus:.1f} us a call), plain {plain_ms:.3f} ms, bound "
        f"{bound:.4g} ms ({tally.row()['bound_by']}); emd_exact x1000 {value:.4f}")
    return {**tally.row(), "rounds": rounds, "bidder_rows": rows, "fallback_points": left,
            "shape": name, "emd_exact_x1000": value, "eps": EVAL_EPS, "iters": EVAL_ROUNDS,
            "points": k}


def check_metrics_card_vs_cpu(dev) -> dict:
    """earth_mover_distance and get_metrics at [4, 2048] on the card
    against the same calls on the CPU."""
    rng = np.random.default_rng(13)
    gt = np.stack([surface_cloud(rng, 2048) for _ in range(4)])
    pred = (gt + 0.01 * rng.normal(size=gt.shape)).astype(np.float32)
    emd = [obj_metrics.earth_mover_distance(torch.from_numpy(pred).to(d),
                                            torch.from_numpy(gt).to(d)).cpu().numpy()
           for d in (dev, "cpu")]
    card, cpu = (object_evaluation.get_metrics(pred, gt, device=d) for d in (dev, "cpu"))
    emd_rel = float(np.abs(emd[0] - emd[1]).max() / np.abs(emd[1]).min())
    rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in card}
    log(f"earth_mover_distance [4, 2048] card vs CPU: {emd[0].tolist()} vs {emd[1].tolist()} "
        f"(relative {emd_rel:.3g}, tol {EMD_CARD_REL}); get_metrics card {card}, CPU {cpu} "
        f"(relative {json.dumps({k: float(f'{v:.3g}') for k, v in rel.items()})})")
    if not (emd_rel <= EMD_CARD_REL and rel["EMD"] <= EMD_CARD_REL and rel["CD"] <= CD_CARD_REL
            and card["MSE"] == cpu["MSE"]):
        raise AssertionError(f"object metrics card vs CPU: emd {emd_rel}, get_metrics {rel}")
    return {"emd_rel": emd_rel, "get_metrics_rel": rel, "card": card, "cpu": cpu}


def objects(dev, run: Path, root: Path) -> dict:
    """Phase 9: the object evaluation protocol at full width through
    python -m p2p_bridge_tpu_torch.evaluate_objects, with phase 7's
    checkpoint in ``run``."""
    t_phase = time.perf_counter()
    here = Path(__file__).resolve().parent
    data = root / "objects"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(here / "scripts" / "make_synthetic_punet.py"), "--out",
                    str(data), "--train", "0", "--test", "3"], check=True, capture_output=True,
                   text=True, timeout=600)
    shutil.copy(here / "configs" / "PVDS_PUNet.yaml", run / "opt.yaml")
    tree_s = time.perf_counter() - t0
    log(f"phase 9: synthetic PU-Net test tree (3 shapes, 8192-point GT, meshes, 10k and 50k "
        f"inputs at 3 noise levels) written in {tree_s:.1f} s")
    by_mode, launches, cell_ms, wall = {}, {}, {}, {}
    for mode in ("exact", "bucketed"):
        by_mode[mode], launches[mode], cell_ms[mode], wall[mode] = evaluate_objects_cli(
            run, data, root / f"objects_{mode}", mode)
        log(f"evaluate_objects ({mode} recombination, 5 steps, bf16 PVDS_PUNet from phase 7) "
            f"{wall[mode]:.0f} ms; launches {launches[mode]}")
        for cell in OBJECT_CELLS:
            log(f"  {cell}: ms {json.dumps({k: round(v, 1) for k, v in cell_ms[mode][cell].items()})}"
                f"; {json.dumps({k: float(f'{v:.6g}') for k, v in by_mode[mode][cell].items()})}")
    floor = noisy_floor(data, root / "objects_noisy", dev)
    for cell in OBJECT_CELLS:
        log(f"  {cell} noisy input: "
            f"{json.dumps({k: float(f'{v:.6g}') for k, v in floor[cell].items()})}")
    k7 = check_auction_eval_setting(
        data, root / "objects_exact" / f"PUNet_{OBJECT_CELLS[0]}_steps5", dev)
    card_cpu = check_metrics_card_vs_cpu(dev)
    seconds = time.perf_counter() - t_phase
    log(f"phase 9: {seconds:.1f} s")
    return {"metrics": {**{m: by_mode[m] for m in by_mode}, "noisy": floor},
            "launches": launches, "cell_ms": cell_ms, "cli_ms": wall, "tree_s": tree_s,
            "auction_eval": k7, "card_vs_cpu": card_cpu, "seconds": seconds}


# ---------------------------------------------------------------- phase 11
DIST_B = 4  # the global batch of the two-rank step: 2 clouds a rank
DIST_ROOM_POINTS = 30_000  # 32 patches of 4096 at k = 4: one batch of 32
DIST_TRAIN_STEPS = 3
# tests/test_torch_distributed.py's f32 tolerances: the loss and the norms
# relative, the gradients and Adam's moments absolute of the largest, the
# sharded room prediction absolute
DIST_STEP_REL = 1e-5
DIST_GRAD_TOL = 5e-5
DIST_ROOM_TOL = 1e-6


def flash_attention(dev) -> dict:
    """(a) PVDS_PUNet at full width with attention_type "flash" (random
    weights from seed 0), bf16 as shipped and an f32 twin: the attention's
    parameters f32, the f32 forward on the card against the CPU at B = 1,
    the bf16 forward against the f32 one, two bf16 forwards at B = 73
    bit-equal, one bucketed 50k denoise with every backbone kernel and the
    cluster FPS launched."""
    cfg = pvds_punet()
    cfg["model"]["PVD"]["attention_type"] = "flash"
    model = build_unet_from_config(cfg).eval()
    init_parameters(model, torch.Generator().manual_seed(0))
    att = model.global_att
    if type(att).__name__ != "Attention" or {p.dtype for p in att.parameters()} != {torch.float32}:
        raise AssertionError(f"global_att: {type(att).__name__}, parameters in "
                             f"{ {p.dtype for p in att.parameters()} }")
    twin_cfg = copy.deepcopy(cfg)
    twin_cfg["model"]["compute_dtype"] = "f32"
    twin = build_unet_from_config(twin_cfg).eval()
    twin.load_state_dict(model.state_dict())
    model.to(dev)
    twin.to(dev)
    log(f"PVDS_PUNet with full attention at the bottleneck: "
        f"{sum(p.numel() for p in model.parameters()):,} parameters, bf16 and an f32 twin")
    forward = check_forward(model, twin, dev, cfg, b=1)
    forward["determinism"] = check_determinism(model, dev)
    del twin
    bridge = P2PBridge.from_config(cfg, model)
    pcl = cloud_50k()
    denoise(bridge, pcl, "bucketed", dev)  # warm-up
    kernels.reset_launch_counts()
    ms = denoise(bridge, pcl, "bucketed", dev)
    launches = dict(kernels.launch_counts)
    log(f"flash: denoise 50,000 points, bf16, bucketed: {ms:.1f} ms; launches {launches}")
    idle = [k for k in SERVING + ("fps_cluster",) if launches.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the flash-attention path: {idle}")
    return {"forward": forward, "denoise_ms": ms, "launches": launches}


def run_bench() -> dict:
    """(b) python -m p2p_bridge_tpu_torch.bench through its main (it prints
    its JSON line and holds every pipelined output torch.equal to the
    synchronous one): the launch counts set to 0 before and read after,
    every backbone kernel and the cluster FPS launched, 0 < mfu <= 1, no
    synchronising call in its profiler window of pipelined calls, and the
    second call queued before the first call's last kernel ended."""
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    line = port_bench.main([])
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    log(f"bench: {seconds:.1f} s; launches {launches}")
    idle = [k for k in SERVING + ("fps_cluster",) if launches.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"kernels not launched by the bench: {idle}")
    if not (0 < line["mfu"] <= 1 and 0 < line["device_mfu"] <= 1):
        raise AssertionError(f"mfu {line['mfu']}, device_mfu {line['device_mfu']}")
    if line["host_syncs"] or not line["overlap_ms"] > 0:
        raise AssertionError(f"pipelined calls: {line['host_syncs']} synchronising calls, the "
                             f"next call queued {line['overlap_ms']} ms before the last kernel "
                             "ended")
    return {"line": line, "launches": launches, "seconds": seconds}


def dist_step_config(cfg: dict) -> dict:
    """PVDS_PUNet's f32 twin without dropout: the two-rank comparison's
    model (the CPU test's terms: f32, the masks off)."""
    cfg = copy.deepcopy(cfg)
    cfg["model"]["compute_dtype"] = "f32"
    cfg["model"]["dropout"] = 0.0
    return cfg


def one_step(cfg: dict, batch: dict, dev, mesh=None) -> tuple:
    """(model, state, metrics) of one train_step of ``cfg``'s model from
    seed 0's weights, the generators reseeded, the K7 alignment on."""
    model = build_unet_from_config(cfg).train()
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(dev)
    state = init_train_state(model, cfg)
    torch.cuda.manual_seed(12)
    metrics = train_step(P2PBridge.from_config(cfg, model), state, batch,
                         torch.Generator(dev).manual_seed(11), grad_clip=1.0,
                         align_cfg={"eps": 0.01, "iters": 100}, return_grads=True, mesh=mesh)
    return model, state, metrics


def step_record(model, state, metrics) -> dict:
    """A step's results on the CPU: the loss and the norms, the gradients
    before the clip, the parameters, Adam's moments and the EMA after it."""
    out = {k: metrics[k].detach().cpu() for k in ("loss", "grad_norm", "param_norm")}
    for n, p in model.named_parameters():
        opt = state.optimizer.state[p]
        out.update({f"grad/{n}": metrics["grads"][n].cpu(), f"param/{n}": p.detach().cpu(),
                    f"exp_avg/{n}": opt["exp_avg"].cpu(),
                    f"exp_avg_sq/{n}": opt["exp_avg_sq"].cpu(),
                    f"ema/{n}": state.ema.params[n].cpu()})
    return out


def step_differences(got: dict, want: dict, lr: float) -> dict:
    """The largest difference of each kind, relative as the tolerances
    read them; "update" is the worst ratio of a parameter's or EMA's
    difference to what tests/test_torch_train.py allows it at learning
    rate ``lr``."""
    def worst(prefix):
        keys = [k for k in want if k.startswith(prefix)]
        scale = max(want[k].abs().max().item() for k in keys)
        return max((got[k] - want[k]).abs().max().item() for k in keys) / scale

    out = {k: abs(got[k].item() - want[k].item()) / abs(want[k].item())
           for k in ("loss", "grad_norm", "param_norm")}
    out.update({p[:-1]: worst(p) for p in ("grad/", "exp_avg/", "exp_avg_sq/")})
    clip = min(1.0, 1.0 / (want["grad_norm"].item() + 1e-6))
    gscale = max(want[k].abs().max().item() for k in want if k.startswith("grad/"))
    ratio = 0.0
    for k in want:
        if k.startswith(("param/", "ema/")):
            g = want["grad/" + k.split("/", 1)[1]].abs() * clip
            allowed = lr * torch.clamp(1e-3 + 10 * DIST_GRAD_TOL * gscale * clip
                                            / torch.clamp(g, min=1e-30), max=2.0 + 1e-3)
            ratio = max(ratio, ((got[k] - want[k]).abs() / allowed).max().item())
    out["update"] = ratio
    return out


def dist_room(points: int, root: Path) -> tuple:
    """(points [N, 3] f32, features [N, C]) of a synthetic ScanNet++ scan."""
    scan, _ = synthetic_room(root, np.random.default_rng(21), scene="dist", points=points)
    feats = np.load(scan.parent.parent / "features" / "dino_iphone.npy").T
    return read_ply(str(scan))["points"].astype(np.float32), np.ascontiguousarray(feats)


def room_bridge(dev, dtype: str, head_scale: float = 1.0):
    """PVDL_SNPP (random weights from seed 0) computing in ``dtype``, its
    head scaled by ``head_scale``, on ``dev``."""
    cfg = pvdl_snpp()
    cfg["model"]["compute_dtype"] = dtype
    model = build_unet_from_config(cfg).eval()
    init_parameters(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.classifier[2].weight.mul_(head_scale)
        model.classifier[2].bias.mul_(head_scale)
    return P2PBridge.from_config(cfg, model.to(dev))


def sharded_room(bridge, pts, feats, mesh=None) -> np.ndarray:
    with torch.no_grad():
        return rooms.denoise_room(bridge, pts, steps=ROOM_STEPS, k=ROOM_K,
                                  patch_size=ROOM_PATCH, batch_size=ROOM_BATCH,
                                  query_radius=0.3, room_features=feats, use_feat=True,
                                  mesh=mesh)["denoised"]


def gloo_rank(rank: int, world: int, store: str, root: str) -> None:
    """One of two ranks sharing card 0 over gloo (a spawned process): the
    f32 step on its half of the saved global batch and the f32 sharded room,
    saved for the parent; and which gloo collectives take CUDA tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    initialize_distributed("gloo", dev, init_method=f"file://{store}", world_size=world,
                           rank=rank)
    mesh = make_data_mesh(dev)
    root = Path(root)
    probe = {}
    x = torch.full((4,), float(rank + 1), device=dev)
    for name, call in (("all_reduce", lambda: torch.distributed.all_reduce(x.clone())),
                       ("broadcast", lambda: torch.distributed.broadcast(x.clone(), 0)),
                       ("all_gather", lambda: torch.distributed.all_gather(
                           [torch.empty_like(x) for _ in range(world)], x))):
        try:
            call()
            probe[name] = "takes CUDA tensors"
        except RuntimeError as e:  # reported: the mesh's collectives would fail below
            probe[name] = str(e).splitlines()[0][:120]
    batch = torch.load(root / "dist_batch.pt")
    local = {k: v.to(dev) for k, v in shard_batch(batch, mesh).items()}
    cfg = dist_step_config(pvds_punet())
    record = step_record(*one_step(cfg, local, dev, mesh))
    pts, feats = dist_room(DIST_ROOM_POINTS, root / f"rank{rank}")
    denoised = sharded_room(room_bridge(dev, "f32", 0.01), pts, feats, mesh)
    torch.save({"step": record, "room": torch.from_numpy(denoised), "probe": probe},
               root / f"gloo_rank{rank}.pt")
    torch.distributed.destroy_process_group()


def torchrun_train(data_dir: Path, root: Path) -> dict:
    """python -m torch.distributed.run --nproc_per_node 2 -m
    p2p_bridge_tpu_torch.train: two ranks sharing card 0 over gloo train
    PVDS_PUNet as shipped (bf16, bs 32: 16 a rank) for DIST_TRAIN_STEPS
    steps on phase 7's tree (data.pool_size 32, two batches of a rank);
    every logged loss finite, one checkpoint at the last step, saved by
    rank 0 alone."""
    runs = root / "ddp_runs"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "p2p_bridge_tpu_torch.train", "--config",
           str(REPO / "configs" / "PVDS_PUNet.yaml"), "--save_dir", str(runs), "--name", "ddp",
           "--device", "cuda:0", "--dist_backend", "gloo", "--data.data_dir", str(data_dir),
           "--data.pool_size", "32", "--training.steps", str(DIST_TRAIN_STEPS),
           "--training.log_interval", "1", "--training.save_interval", "1000",
           "--use_wandb", "false"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    text = run.stdout + run.stderr
    if run.returncode != 0:
        raise AssertionError(f"torchrun training exited {run.returncode}:\n{text[-6000:]}")
    losses = [float(v) for v in re.findall(r"loss:\s+(\S+)", text)]
    saves = text.count("Saved final checkpoint")
    ckpt = torch.load(runs / "ddp" / "model.pt", map_location="cpu", weights_only=True)
    log(f"torchrun, 2 ranks on card 0 over gloo, PVDS_PUNet bf16 bs 32 (16 a rank): "
        f"{DIST_TRAIN_STEPS} steps in {seconds:.1f} s, losses {losses}, checkpoint saves "
        f"{saves}, checkpoint step {ckpt['step']}")
    if not (len(losses) == DIST_TRAIN_STEPS and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"torchrun training losses: {losses}\n{text[-4000:]}")
    if saves != 1 or ckpt["step"] != DIST_TRAIN_STEPS:
        raise AssertionError(f"{saves} checkpoint saves, step {ckpt['step']}")
    return {"seconds": seconds, "losses": losses, "checkpoint_step": ckpt["step"]}


def distributed(dev, data_dir: Path, root: Path) -> dict:
    """(c) W = 1 over NCCL: a PVDS_PUNet train_step (bf16 as shipped, bs 32,
    dropout, K7) through the mesh bit-equal to the plain step, and
    denoise_room with the mesh bit-equal to the unsharded call; then two
    spawned ranks sharing the card over gloo (f32, the CPU test's
    tolerances) and torchrun training at W = 2."""
    out = {}
    cfg = train_config(data_dir, root / "unused")
    batch = aligned_batch(cfg, dev)
    initialize_distributed("nccl", dev, init_method=f"file://{root / 'nccl_store'}",
                           world_size=1, rank=0)
    try:
        mesh = make_data_mesh(dev)
        plain = step_record(*one_step(cfg, batch, dev))
        meshed = step_record(*one_step(cfg, batch, dev, mesh))
        differ = [k for k in plain if not torch.equal(plain[k], meshed[k])]
        log(f"W = 1 over NCCL: a bf16 PVDS_PUNet step (bs {TRAIN_B}) through the mesh against "
            f"the plain step: {'bit-equal' if not differ else f'differs in {differ[:5]}'} in "
            f"{len(plain)} tensors (loss, norms, gradients, parameters, moments, EMA)")
        if differ:
            raise AssertionError(f"the W = 1 NCCL step differs from the plain step: {differ[:5]}")
        pts, feats = dist_room(DIST_ROOM_POINTS, root)
        bridge = room_bridge(dev, "bf16")
        single = sharded_room(bridge, pts, feats)
        sharded = sharded_room(bridge, pts, feats, mesh)
        log(f"W = 1 over NCCL: denoise_room of {DIST_ROOM_POINTS:,} points (PVDL_SNPP bf16) "
            f"with the mesh {'bit-equal to' if np.array_equal(single, sharded) else 'differs from'}"
            " the unsharded call")
        if not np.array_equal(single, sharded):
            raise AssertionError("the W = 1 NCCL room differs by up to "
                                 f"{np.abs(single - sharded).max()}")
        del bridge
        out["nccl_w1"] = {"step_bit_equal": True, "room_bit_equal": True}
    finally:
        torch.distributed.destroy_process_group()

    global_batch = {k: v[:DIST_B].cpu() for k, v in batch.items()}
    torch.save(global_batch, root / "dist_batch.pt")
    scfg = dist_step_config(cfg)
    want = step_record(*one_step(scfg, {k: v.to(dev) for k, v in global_batch.items()}, dev))
    want_room = sharded_room(room_bridge(dev, "f32", 0.01), pts, feats)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=gloo_rank, args=(r, 2, str(root / "gloo_store"), str(root)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"the gloo ranks exited {codes}")
    ranks = [torch.load(root / f"gloo_rank{r}.pt") for r in range(2)]
    diffs = step_differences(ranks[0]["step"], want, float(scfg["training"]["optimizer"]["lr"]))
    room_err = float(np.abs(ranks[0]["room"].numpy() - want_room).max())
    same = (all(torch.equal(ranks[0]["step"][k], ranks[1]["step"][k]) for k in want)
            and torch.equal(ranks[0]["room"], ranks[1]["room"]))
    log(f"two ranks sharing the card over gloo ({time.perf_counter() - t0:.1f} s): "
        f"gloo with CUDA tensors {ranks[0]['probe']}; the f32 step (B = {DIST_B}, 2 a rank) "
        f"against W = 1: {({k: f'{v:.3g}' for k, v in diffs.items()})} (tolerances: loss and "
        f"norms {DIST_STEP_REL}, gradients {DIST_GRAD_TOL}, moments {2 * DIST_GRAD_TOL}, "
        f"update ratio 1); the sharded f32 room (head x 0.01) against W = 1: max abs "
        f"{room_err:.3g} (tol {DIST_ROOM_TOL}); the ranks {'agree' if same else 'differ'}")
    bad = [k for k in ("loss", "grad_norm", "param_norm") if diffs[k] > DIST_STEP_REL]
    bad += [k for k in ("grad",) if diffs[k] > DIST_GRAD_TOL]
    bad += [k for k in ("exp_avg", "exp_avg_sq") if diffs[k] > 2 * DIST_GRAD_TOL]
    bad += ["update"] if diffs["update"] > 1.0 else []
    bad += ["room"] if room_err > DIST_ROOM_TOL else []
    bad += ["ranks"] if not same else []
    if bad:
        raise AssertionError(f"the two-rank gloo run misses its tolerances in {bad}")
    out["gloo_w2"] = {"step": diffs, "room_max_abs": room_err, "probe": ranks[0]["probe"],
                      "seconds": time.perf_counter() - t0}
    out["torchrun_w2"] = torchrun_train(data_dir, root)
    return out


def phase11(dev, root: Path) -> dict:
    """Phase 11: full attention, the bench, data parallelism."""
    t0 = time.perf_counter()
    out = {"flash": flash_attention(dev)}
    torch.cuda.empty_cache()
    out["bench"] = run_bench()
    torch.cuda.empty_cache()
    out["distributed"] = distributed(dev, root / "data", root / "dist")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 11: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 12
RESUME_STEPS = 3  # steps resumed from phase 7's step 31


def resume_config(cfg: dict, out_dir: Path, model_path: str) -> dict:
    """Phase 7's configuration resumed from ``model_path`` for RESUME_STEPS
    steps into ``out_dir``, in exact epochs (the same batches in every
    run), without the evaluation, the watch step and the profile."""
    cfg = copy.deepcopy(cfg)
    cfg.pop("profile_dir", None)
    cfg["model_path"] = model_path
    cfg["output_dir"] = str(out_dir)
    cfg["data"]["loader"] = "epoch"
    cfg["training"].update(steps=TRAIN_STEPS + RESUME_STEPS, viz_interval=10 ** 9,
                           watch_interval=0, save_interval=10 ** 9)
    return cfg


def state_differences(a, b) -> dict:
    """Which parts of two TrainStates differ in any bit: parameters, EMA,
    each Adam state entry (its dtype and device too), the rate, the
    schedule's count, the step."""
    out = {"params": [], "ema": [], "adam": []}
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters(), strict=True):
        if not torch.equal(p, q):
            out["params"].append(name)
        if a.ema is not None and not torch.equal(a.ema.params[name], b.ema.params[name]):
            out["ema"].append(name)
        sa, sb = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        if sa.keys() != sb.keys() or any(
                not torch.equal(sa[k], sb[k].to(sa[k].device)) or sa[k].dtype != sb[k].dtype
                or sa[k].device != sb[k].device for k in sa):
            out["adam"].append(name)
    out["lr"] = a.optimizer.param_groups[0]["lr"] != b.optimizer.param_groups[0]["lr"]
    out["schedule"] = a.schedule.last_epoch != b.schedule.last_epoch
    out["step"] = a.step != b.step
    return {k: v for k, v in out.items() if v}


def trained_state(cfg: dict, path: Path, dev):
    """A TrainState of ``cfg`` on the card restored from the port's
    checkpoint ``path``."""
    model = build_unet_from_config(cfg).to(dev)
    return restore_checkpoint(str(path), init_train_state(model, cfg))


def denoise_exported(npz: Path, root: Path) -> dict:
    """python -m p2p_bridge_tpu_torch.denoise_object with the exported file
    (--use_ema, 5 steps, exact recombination) on a 10,000-point cloud."""
    cloud = surface_cloud(np.random.default_rng(12), 10_000)
    src = root / "cloud.xyz"
    np.savetxt(src, cloud, fmt="%.6f")
    t0 = time.perf_counter()
    out = denoise_object.main(["--data_path", str(src), "--model_path", str(npz), "--use_ema",
                               "--steps", "5", "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = read_xyz(out)
    if got.shape != cloud.shape or not np.isfinite(got).all():
        raise AssertionError(f"denoise_object from {npz.name}: shape {got.shape}, finite "
                             f"{bool(np.isfinite(got).all())}")
    log(f"denoise_object --model_path {npz.name} --use_ema: {got.shape[0]} points, finite, "
        f"{seconds:.1f} s")
    return {"points": int(got.shape[0]), "finite": True, "s": seconds}


def resumed_from_export(dev, root: Path) -> dict:
    """Phase 12: phase 7's trained PVDS_PUNet (model.pt, 31 steps) written
    in the layout export_jax_checkpoint.py writes for a JAX run, imported on
    the card bit-equal, resumed for RESUME_STEPS steps through ``train``
    from that file and from model.pt (parameters and moments bit-equal, the
    file's EMA in its copy phase), and read by denoise_object."""
    t_phase = time.perf_counter()
    cfg = train_config(root / "data", root / "run")
    pt = root / "run" / "model.pt"
    work = root / "resume"
    work.mkdir()
    npz = work / "run.npz"
    trained = trained_state(cfg, pt, dev)
    t0 = time.perf_counter()
    arrays = jax_checkpoint_arrays(trained, cfg)
    save_jax_checkpoint(str(npz), arrays)
    write_run_config(dict(cfg, output_dir=str(work)))
    write_s = time.perf_counter() - t0
    values = sum(int(a.size) for a in arrays.values() if a.dtype == np.float32)
    t0 = time.perf_counter()
    imported = init_train_state(build_unet_from_config(cfg).to(dev), cfg)
    restore_jax_checkpoint(str(npz), imported)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    differ = state_differences(trained, imported)
    if differ or imported.step != TRAIN_STEPS or imported.ema.step != 0:
        raise AssertionError(f"import of {npz.name} differs from the written state: {differ}, "
                             f"step {imported.step}, EMA count {imported.ema.step}")
    log(f"phase 12: phase 7's state (step {trained.step}) written as {npz.name}: "
        f"{len(arrays)} arrays, {values:,} f32 values, {npz.stat().st_size / 1e6:.1f} MB in "
        f"{write_s:.1f} s; imported on the card in {import_s:.1f} s, bit-equal in parameters, "
        f"EMA, exp_avg, exp_avg_sq, Adam's step tensors, rate and counts (EMA count restarted)")
    del trained, imported
    torch.cuda.empty_cache()

    resumed, launches, seconds = {}, None, {}
    for name, path in (("npz", npz), ("model.pt", pt)):
        rcfg = resume_config(cfg, work / name.replace(".", "_"), str(path))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "npz":
            kernels.reset_launch_counts()
        resumed[name] = train(rcfg, dev)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        if name == "npz":
            launches = dict(kernels.launch_counts)
    a, b = resumed["npz"], resumed["model.pt"]
    differ = state_differences(a, b)
    ema_is_params = all(torch.equal(a.ema.params[n], p) for n, p in a.model.named_parameters())
    idle = [k for k in TRAINING if launches.get(k, 0) == 0]
    if set(differ) - {"ema"} or not ema_is_params or idle or a.step != b.step:
        raise AssertionError(f"resumed runs: differ in {sorted(differ)}, the file's EMA equal to "
                             f"its parameters {ema_is_params}, kernels not launched {idle}")
    log(f"phase 12: {RESUME_STEPS} steps resumed through train from {npz.name} "
        f"({seconds['npz']:.1f} s) and from model.pt ({seconds['model.pt']:.1f} s): parameters, "
        f"exp_avg, exp_avg_sq bit-equal; the file's EMA equals its parameters (count "
        f"{a.ema.step}, copy phase), model.pt's EMA count {b.ema.step}; launches {launches}")
    del resumed, a, b
    torch.cuda.empty_cache()
    denoised = denoise_exported(npz, work)
    out = {"arrays": len(arrays), "f32_values": values, "file_bytes": npz.stat().st_size,
           "write_s": write_s, "import_s": import_s, "import_bit_equal": True,
           "resume_s": seconds, "resumed_bit_equal": ["params", "exp_avg", "exp_avg_sq", "step"],
           "ema_copy_phase": True, "launches": launches, "denoise": denoised,
           "seconds": time.perf_counter() - t_phase}
    log(f"phase 12: {out['seconds']:.1f} s")
    return out


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
    with tempfile.TemporaryDirectory() as work:
        trained = training(dev, plan, Path(work))
        results.update(trained["results"])
        train_launches = trained["run"]["launches"]
        torch.cuda.empty_cache()
        room_run = room(dev)
        torch.cuda.empty_cache()
        room_train = room_training(dev, Path(work) / "rooms")
        torch.cuda.empty_cache()
        object_run = objects(dev, Path(work) / "run", Path(work))
        torch.cuda.empty_cache()
        (Path(work) / "dist").mkdir()
        last = phase11(dev, Path(work))
        torch.cuda.empty_cache()
        carried = resumed_from_export(dev, Path(work))

    entries = []
    for name, (src, replaces) in KERNELS.items():
        per_dtype = results[name]
        dtype = MAIN if MAIN in per_dtype else "f32"  # fps, auction: f32 on both paths
        by_path = {f"{d} {m}": r["launches"].get(name, 0)
                   for d, modes in run.items() for m, r in modes.items()}
        by_path["bf16 train step"] = train_launches[name]
        by_path["bf16 room"] = room_run["launches"].get(name, 0)
        by_path["bf16 room train step"] = room_train["run"]["launches"].get(name, 0)
        by_path[f"bf16 train, {RESUME_STEPS} steps resumed from the exported file"] = \
            carried["launches"].get(name, 0)
        for mode, counts in object_run["launches"].items():
            by_path[f"bf16 evaluate_objects {mode}"] = counts.get(name, 0)
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
                 "device_functions_per_call": DEVICE_LAUNCHES.get(name),
                 "max_abs_err_by_dtype": {d: t.err for d, t in per_dtype.items()},
                 "f32": per_dtype["f32"].row(), "timed": timed}
        if name == "auction_emd":
            entry["evaluation"] = object_run["auction_eval"]
        if name in room_train["results"]:
            entry["room_train_shapes"] = {d: t.row() for d, t in
                                          room_train["results"][name].items()}
        entries.append(entry)
    line = {"kernels": entries, "forward": forward, "launch_path_host_us": launch_costs,
            "denoise_50k_ms": {f"{d} {m}": r["ms"] for d, modes in run.items()
                               for m, r in modes.items()},
            "profile_bf16": profile,
            "train": {"gradient": trained["gradient"], "checkpoint": trained["checkpoint"],
                      "k1_backward_cudnn": trained["k1_backward_cudnn"],
                      "determinism_audit": trained["determinism_audit"],
                      **{k: v for k, v in trained["run"].items() if k != "launches"}},
            "room": {k: v for k, v in room_run.items() if k != "launches"},
            "room_train": {**{k: v for k, v in room_train.items() if k not in ("results", "run")},
                           **{k: v for k, v in room_train["run"].items() if k != "launches"}},
            "objects": {k: v for k, v in object_run.items()
                        if k not in ("launches", "auction_eval")},
            "phase11": last,
            "phase12": {k: v for k, v in carried.items() if k != "launches"}}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
