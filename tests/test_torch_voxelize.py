"""Kernel K2 (voxelize) and the launch path every kernel goes through, on
the CPU.

The card holds K2 bit-equal to the plain version run on the CPU, so the
plain version's summation order is pinned here: each voxel's points in
ascending index, in f32, from 0. The CUDA branch of every op wrapper is
driven into a recording stand-in for the kernel library: its tensor check
rejects what the kernels do not take, and it passes each C entry point
exactly the arguments that ``kernels._SIGNATURES`` declares, which in turn
match the entry points in ``csrc/``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.metrics import emd_auction
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config
from p2p_bridge_tpu_torch.ops import ball_query as bq_ops
from p2p_bridge_tpu_torch.ops import conv3d_gn as conv_ops
from p2p_bridge_tpu_torch.ops import devoxelize as devox_ops
from p2p_bridge_tpu_torch.ops import fps as fps_ops
from p2p_bridge_tpu_torch.ops import group_norm as gn_ops
from p2p_bridge_tpu_torch.ops import interpolate as interp_ops
from p2p_bridge_tpu_torch.ops import voxelize as vox_ops
from p2p_bridge_tpu_torch.utils.config import load_yaml

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


# ------------------------------------------------------- summation order
def dense_cloud(seed, B, N, C, r):
    """Features spread over six decades (so that f32 sums depend on their
    order) and voxel coordinates crowded into 3^3 voxels of an r^3 grid, a
    few dozen points to a voxel."""
    rng = np.random.default_rng(seed)
    feat = (rng.normal(size=(B, N, C)) * 10.0 ** rng.uniform(-3, 3, size=(B, N, C)))
    vox = rng.integers(r // 2 - 1, r // 2 + 2, size=(B, N, 3)).astype(np.int32)
    return feat.astype(np.float32), vox


def sequential_mean(feat, idx, r3, order):
    """Per-voxel f32 sums, one point after another in ``order``, then the
    f32 divide by max(count, 1)."""
    B, N, C = feat.shape
    acc = np.zeros((B, r3, C), np.float32)
    cnt = np.zeros((B, r3), np.float32)
    for b in range(B):
        for n in order:
            acc[b, idx[b, n]] += feat[b, n]
            cnt[b, idx[b, n]] += np.float32(1.0)
    return acc / np.maximum(cnt, np.float32(1.0))[..., None], cnt


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,C", [(8, 35), (8, 64), (16, 35), (16, 64)])
def test_plain_voxelize_sums_in_ascending_point_order(r, C, dtype, threads):
    """The plain version is bit-equal to a sequential ascending-index f32
    numpy sum, grid and counts, in f32 and bf16, with 1 or 4 threads; the
    descending order gives other bits, so the comparison can tell orders
    apart."""
    B, N = 2, 2048
    feat, vox = dense_cloud(r + C, B, N, C, r)
    tf = torch.from_numpy(feat).to(dtype)
    f32 = tf.float().numpy()  # the values the kernel reads
    idx = vox_ops.flat_voxel_index(torch.from_numpy(vox), r).numpy()
    want, want_cnt = sequential_mean(f32, idx, r ** 3, range(N))
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got, cnt = vox_ops._avg_voxelize_plain(tf, torch.from_numpy(vox), r)
    finally:
        torch.set_num_threads(before)
    assert got.dtype == dtype
    assert torch.equal(cnt, torch.from_numpy(want_cnt))
    assert torch.equal(got, torch.from_numpy(want).to(dtype))
    assert cnt.max() > 40  # crowded voxels
    backwards, _ = sequential_mean(f32, idx, r ** 3, range(N - 1, -1, -1))
    assert not np.array_equal(backwards, want)


# ---------------------------------------------------------- shape check
def voxelize_calls(config):
    """(N, r, C) of every voxelize call of a config's backbone forward."""
    cfg = load_yaml(str(CONFIGS / config))
    with torch.device("meta"):
        plan = build_unet_from_config(cfg).plan
    n, fine, calls = cfg["data"]["npoints"], [], set()
    for stage in plan.sa_stages:
        fine.append(n)
        calls |= {(n, spec.resolution, spec.in_channels) for spec in stage.convs}
        n = stage.sa.num_centers
    for i, stage in enumerate(plan.fp_stages):
        n = fine[-1 - i]
        calls |= {(n, spec.resolution, spec.in_channels) for spec in stage.convs}
    return cfg["training"]["bs"], calls


ROOMS_CALLS = {(4096, 32, 64), (4096, 32, 67), (4096, 32, 128), (1024, 16, 192),
               (1024, 16, 256), (256, 8, 320), (256, 8, 512), (64, 8, 512)}
CALLS = {"PVDS_PUNet.yaml": {(2048, 32, 35), (2048, 32, 64), (512, 16, 128), (128, 8, 192),
                             (32, 8, 256), (128, 8, 256)},
         "PVDL_SNPP.yaml": ROOMS_CALLS, "PVDL_ARKIT.yaml": ROOMS_CALLS}


@pytest.mark.parametrize("config", sorted(CALLS))
def test_voxelize_kernel_takes_every_config_call(config):
    """K2's shape check passes every voxelize call of the shipped configs,
    at their training batch and at the 73 patches of a 50k denoise, and
    refuses more points, a finer grid or more clouds than it can hold."""
    bs, calls = voxelize_calls(config)
    assert calls == CALLS[config]
    for n, r, c in calls:
        for B in (bs, 73):
            vox_ops.check_voxelize_shape(B, n, r, c)
    for B, N, r, C in ((1, 4097, 32, 64), (1, 8192, 8, 64), (1, 2048, 33, 64),
                       (2 ** 16, 2048, 8, 64), (1, 2048, 32, 2 ** 16), (1, 0, 8, 64)):
        with pytest.raises(ValueError, match="avg_voxelize kernel takes"):
            vox_ops.check_voxelize_shape(B, N, r, C)


# ------------------------------------------------- launch path, stand-in
class StandIn:
    """Records every entry-point call; a launch returns 0, a size query a
    few bytes."""

    def __init__(self):
        self.calls = []

    def entry_points(self):
        return {name: self._entry(name, restype)
                for name, (restype, _) in kernels._SIGNATURES.items()}

    def _entry(self, name, restype):
        def fn(*args):
            self.calls.append((name, args))
            return {ctypes.c_longlong: 64, ctypes.c_char_p: b"stand-in"}.get(restype, 0)
        return fn


@pytest.fixture
def stand_in(monkeypatch):
    lib = StandIn()
    monkeypatch.setattr(kernels, "entry_points", lib.entry_points)
    monkeypatch.setattr(kernels, "current_stream", lambda device: 0x7F00)
    before = dict(kernels.launch_counts)
    yield lib
    kernels.launch_counts.update(before)


def _rand(*shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.rand(*shape, generator=g).to(dtype)


def _ints(hi, *shape):
    return torch.randint(0, hi, shape, generator=torch.Generator().manual_seed(hi),
                         dtype=torch.int32)


# op -> (kernel, entry points in call order, inputs(dtype), call(inputs), the
# input the fault tests alter); every input's shape follows from the others
OPS = {
    "fps": ("fps", ["p2pb_fps"],
            lambda dt: [_rand(2, 64, 3)],
            lambda t: fps_ops._furthest_point_sample_cuda(t[0], 8), 0),
    "fps_cluster": ("fps_cluster", ["p2pb_fps_cluster_scratch_bytes", "p2pb_fps_cluster_units",
                                    "p2pb_fps_cluster"],
                    lambda dt: [_rand(2, fps_ops.CLUSTER_MIN_POINTS + 5, 3)],
                    lambda t: fps_ops._furthest_point_sample_cuda(t[0], 8), 0),
    "ball_query_group": ("ball_query_group", ["p2pb_ball_query_group"],
                         lambda dt: [_rand(2, 8, 3), _rand(2, 64, 3), _rand(2, 64, 6, dtype=dt)],
                         lambda t: bq_ops._ball_query_group_cuda(*t, 0.3, 4), 1),
    "ball_query_group_rel": ("ball_query_group", ["p2pb_ball_query_group_rel"],
                             lambda dt: [_rand(2, 8, 3), _rand(2, 64, 3),
                                         _rand(2, 64, 5, dtype=dt)],
                             lambda t: bq_ops._ball_query_group_cuda(*t, 0.3, 4, rel=True), 1),
    "avg_voxelize": ("avg_voxelize", ["p2pb_avg_voxelize"],
                     lambda dt: [_rand(2, 64, 35, dtype=dt), _ints(8, 2, 64, 3)],
                     lambda t: vox_ops._avg_voxelize_cuda(*t, 8), 1),
    "avg_voxelize_backward": ("avg_voxelize_backward", ["p2pb_avg_voxelize_backward"],
                              lambda dt: [_rand(2, 512, 35, dtype=dt), _ints(512, 2, 64),
                                          _rand(2, 512)],
                              lambda t: vox_ops._avg_voxelize_backward_cuda(*t), 2),
    "conv3d_gn": ("conv3d_gn", ["p2pb_conv3d_gn_scratch_bytes", "p2pb_conv3d_gn"],
                  lambda dt: [_rand(2, 8, 8, 8, 35, dtype=dt), _rand(3, 3, 3, 35, 64, dtype=dt),
                              _rand(64), _rand(2, 64), _rand(2, 64)],
                  lambda t: conv_ops._conv3d_gn_cuda(*t, 8, 1e-5, True), 2),
    "trilinear_devoxelize": ("trilinear_devoxelize", ["p2pb_trilinear_devoxelize"],
                             lambda dt: [_rand(2, 8, 8, 8, 16, dtype=dt), _rand(2, 64, 3) * 7],
                             lambda t: devox_ops._devoxelize_cuda(*t, 8, True), 1),
    "trilinear_devoxelize_no_mean": (
        "trilinear_devoxelize", ["p2pb_trilinear_devoxelize"],
        lambda dt: [_rand(2, 8, 8, 8, 12, dtype=dt), _rand(2, 64, 3) * 7],
        lambda t: devox_ops._devoxelize_cuda(*t, 8, False), 1),
    "three_nn_interpolate": ("three_nn_interpolate", ["p2pb_three_nn_interpolate"],
                             lambda dt: [_rand(2, 64, 3), _rand(2, 16, 3), _rand(2, 16, 8, dtype=dt)],
                             lambda t: interp_ops._three_nn_interpolate_cuda(*t, True), 1),
    "auction_emd": ("auction_emd", ["p2pb_auction_smem_bytes", "p2pb_auction_emd"],
                    lambda dt: [_rand(2, 16, 3), _rand(2, 24, 3)],
                    lambda t: emd_auction._auction_emd_cuda(*t, 0.01, 10), 1),
    # the backward scatter kernel through each of its three wrappers
    "scatter_devoxelize": ("scatter_rows", ["p2pb_scatter_rows"],
                           lambda dt: [_rand(2, 64, 16, dtype=dt), _rand(2, 64, 3) * 7],
                           lambda t: devox_ops._devoxelize_backward_cuda(*t, 8), 1),
    "scatter_ball_query_group": ("scatter_rows", ["p2pb_scatter_rows"],
                                 lambda dt: [_rand(2, 8, 4, 6, dtype=dt), _ints(64, 2, 8, 4)],
                                 lambda t: bq_ops._ball_query_group_backward_cuda(*t, 64), 1),
    "scatter_three_nn_interpolate": (
        "scatter_rows", ["p2pb_scatter_rows"],
        lambda dt: [_rand(2, 64, 8, dtype=dt), _rand(2, 64, 3), _ints(16, 2, 64, 3)],
        lambda t: interp_ops._three_nn_interpolate_backward_cuda(*t, 16), 1),
    "group_norm_act": ("group_norm_act", ["p2pb_group_norm_act"],
                       lambda dt: [_rand(2, 8, 4, 64, dtype=dt), _rand(2, 64), _rand(2, 64)],
                       lambda t: gn_ops._group_norm_act_cuda(*t, 8, 1e-5, True, torch.bfloat16),
                       0),
}
DATA_OPS = {"ball_query_group", "ball_query_group_rel", "avg_voxelize", "avg_voxelize_backward",
            "conv3d_gn", "trilinear_devoxelize", "trilinear_devoxelize_no_mean",
            "three_nn_interpolate", "scatter_devoxelize",
            "scatter_ball_query_group", "scatter_three_nn_interpolate", "group_norm_act"}
OP_CASES = [(op, dt) for op in OPS
            for dt in ((torch.float32, torch.bfloat16) if op in DATA_OPS else (torch.float32,))]


def declared(arg, ctype) -> bool:
    if ctype is ctypes.c_void_p:
        return arg is None or (type(arg) is int and arg > 0)
    if ctype in (ctypes.c_int, ctypes.c_longlong):
        return type(arg) is int
    return ctype is ctypes.c_float and type(arg) is float


@pytest.mark.parametrize("op,dtype", OP_CASES, ids=lambda v: str(v).replace("torch.", ""))
def test_wrapper_passes_the_declared_arguments(stand_in, op, dtype):
    """Each wrapper's CUDA branch passes every entry point it calls exactly
    the arguments its _SIGNATURES entry declares, in count and type, the
    card's index and the stream last, and counts one launch."""
    kernel, entries, make, call, _ = OPS[op]
    before = kernels.launch_counts[kernel]
    call(make(dtype))
    assert [name for name, _ in stand_in.calls] == entries
    for name, args in stand_in.calls:
        argtypes = kernels._SIGNATURES[name][1]
        assert len(args) == len(argtypes), name
        bad = [i for i, (a, ct) in enumerate(zip(args, argtypes)) if not declared(a, ct)]
        assert not bad, f"{name}: arguments {bad} of {args} do not match {argtypes}"
    launch_args = stand_in.calls[-1][1]
    assert launch_args[-2:] == (-1, 0x7F00)  # a CPU tensor's device index, the stream
    assert kernels.launch_counts[kernel] == before + 1


def _faults(t):
    """(fault, altered tensor, exception, message) for one input."""
    wider = torch.cat([t, t[..., :1]], dim=-1)
    strided = torch.stack([t, t], dim=-1)[..., 0]
    other = t.double() if t.is_floating_point() else t.long()
    return [("device", t.to("meta"), ValueError, "device"),
            ("dtype", other, TypeError, "expected"),
            ("shape", wider, ValueError, "shape"),
            ("layout", strided, ValueError, "contiguous")]


# a single-input op takes its device from that input (fps, fps_cluster)
FAULT_CASES = [(op, fault) for op in sorted(OPS) for fault in ("device", "dtype", "shape", "layout")
               if not (fault == "device" and op in ("fps", "fps_cluster"))]


@pytest.mark.parametrize("op,fault", FAULT_CASES)
def test_wrapper_rejects_bad_tensors(stand_in, op, fault):
    """The one combined check of each wrapper raises on an input on another
    device, of another dtype or shape, or not contiguous, before anything
    is launched."""
    kernel, _, make, call, target = OPS[op]
    inputs = make(torch.float32)
    _, bad, exc, match = next(f for f in _faults(inputs[target]) if f[0] == fault)
    inputs[target] = bad
    before = kernels.launch_counts[kernel]
    with pytest.raises(exc, match=match):
        call(inputs)
    assert all(name.endswith("_bytes") for name, _ in stand_in.calls)
    assert kernels.launch_counts[kernel] == before


# ------------------------------------------- C entry points vs signatures
C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float,
           "long long": ctypes.c_longlong, "char*": ctypes.c_char_p}


def c_type(decl: str, named: bool = True):
    """ctypes type of a C parameter ("const void* feat" -> c_void_p) or,
    with ``named`` false, of a return type."""
    decl = decl.replace("const ", "").strip()
    if named:
        decl = re.sub(r"\s*\b\w+$", "", decl)
    return C_TYPES[decl.replace(" *", "*")]


def test_c_entry_points_match_signatures():
    """Every P2PB_API function under csrc/ has the return and argument
    types that kernels._SIGNATURES gives ctypes, and every launching entry
    ends with the card's index and the stream."""
    found = {}
    for src in kernels.SOURCES:
        text = (kernels.CSRC / src).read_text()
        for ret, name, params in re.findall(
                r"P2PB_API\s+([\w\s\*]+?)\s*\b(p2pb_\w+)\s*\(([^)]*)\)", text):
            found[name] = (c_type(ret, named=False), tuple(c_type(p) for p in params.split(",")))
    assert found == kernels._SIGNATURES
    for name, (restype, argtypes) in found.items():
        if restype is ctypes.c_int and name in {e for op in OPS.values() for e in op[1]}:
            assert argtypes[-2:] == (ctypes.c_int, ctypes.c_void_p), name
