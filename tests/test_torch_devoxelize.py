"""Kernel K3's grid mean (``csrc/devoxelize.cu``) and its shape check, on
the CPU, without JAX.

The card holds the kernel's mean torch.equal to ``grid_mean_fixed_order``
run on the CPU. Here that float64 function is held bit-equal to a model of
the kernel written thread by thread (Python floats are IEEE doubles, so a
Python loop adds exactly as one thread's double adds do), with the layout
constants parsed from the source, and close to the plain f32 mean that the
CPU path returns; another order gives other bits on the same data, so the
comparison can tell orders apart.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config
from p2p_bridge_tpu_torch.ops import devoxelize as devox_ops
from p2p_bridge_tpu_torch.utils.config import load_yaml

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SOURCE = (kernels.CSRC / "devoxelize.cu").read_text()


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_layout_constants_follow_the_source():
    assert devox_ops.MEAN_THREADS == constant("kThreads")
    assert devox_ops.MAX_MEAN_BLOCKS == constant("kMaxMeanBlocks")
    assert devox_ops.MEAN_BLOCK_BYTES == constant("kMeanBlockBytes")
    assert devox_ops.BF16_RUN == constant("kRun")
    assert constant("kMeanLoads") % devox_ops.BF16_RUN == 0  # a thread's runs are whole


@pytest.mark.parametrize("r,C,esize,blocks", [(32, 64, 2, 32), (32, 32, 2, 16), (16, 128, 2, 8),
                                              (16, 64, 2, 4), (8, 256, 2, 2), (8, 128, 2, 1),
                                              (4, 8, 2, 1), (32, 64, 4, 32), (16, 64, 4, 8)])
def test_mean_blocks_grow_with_the_grid(r, C, esize, blocks):
    """128 KB of the grid a block or more, 1 to 32 blocks a cloud."""
    assert devox_ops.mean_blocks(r ** 3 * C * esize) == blocks


def spread_grid(seed, B, r, C, dtype, decades=6):
    """Values over ``decades`` decades (a double sum of f32 values rounds
    only where they span more than about 29 bits)."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-decades / 2, decades / 2, size=(B, r, r, r, C))
    return torch.from_numpy((rng.normal(size=scale.shape) * scale).astype(np.float32)).to(dtype)


def kernel_model(grid: torch.Tensor, reverse: bool = False, runs: bool = True) -> torch.Tensor:
    """The kernel's mean, one thread at a time: block `rank` of the cloud's
    S, thread `tid`: channel groups tid % GT, + GT, ...; voxel lane
    rank * VLc + tid // GT, which takes voxels lane, lane + VL, ... in
    ascending order and adds them into one double a channel, bf16 ones in
    runs of 4 summed in f32 first (the last run padded with zeros); then
    each block adds its lanes in ascending order, and the cloud's last block
    adds the blocks in block order and divides by V. ``reverse`` takes each
    lane's voxels in descending order, and without ``runs`` bf16 values go
    to the double one at a time."""
    B, C = grid.shape[0], grid.shape[-1]
    x = grid.reshape(B, -1, C).float().numpy()
    V = x.shape[1]
    vec = devox_ops.mean_vector(grid.dtype, C)
    T, S = constant("kThreads"), devox_ops.mean_blocks(V * C * grid.element_size())
    R = constant("kRun") if grid.dtype == torch.bfloat16 and runs else 1
    G = C // vec
    GT = min(G, T)
    VLc = T // GT
    VL = S * VLc
    out = np.zeros((B, C), np.float32)
    for b in range(B):
        block_sums = []
        for rank in range(S):
            part = [[0.0] * C for _ in range(VLc)]
            for tid in range(VLc * GT):
                vl_local = tid // GT
                vl = rank * VLc + vl_local
                voxels = list(range(vl, V, VL))
                if reverse:
                    voxels.reverse()
                for g in range(tid % GT, G, GT):
                    for j in range(vec):
                        c = g * vec + j
                        seq = [x[b, v, c] for v in voxels]
                        seq += [np.float32(0.0)] * (-len(seq) % R)
                        acc = 0.0
                        for i in range(0, len(seq), R):
                            run = seq[i]
                            for e in range(1, R):
                                run = np.float32(run + seq[i + e])
                            acc += float(run)
                        part[vl_local][c] = acc
            sums = []
            for c in range(C):
                s = 0.0
                for lane in range(VLc):
                    s += part[lane][c]
                sums.append(s)
            block_sums.append(sums)
        for c in range(C):
            s = 0.0
            for rank in range(S):
                s += block_sums[rank][c]
            out[b, c] = np.float32(s / V)
    return torch.from_numpy(out)


# (r, C, dtype): 16-byte loads of 8 bf16 or 4 f32, one element a load where
# C is not a multiple of them, and channel groups beyond a block's threads
MEAN_CASES = [(4, 32, torch.bfloat16), (4, 64, torch.float32), (8, 16, torch.bfloat16),
              (4, 35, torch.bfloat16), (4, 36, torch.float32), (4, 300, torch.bfloat16),
              (2, 2048, torch.bfloat16)]


@pytest.mark.parametrize("r,C,dtype", MEAN_CASES, ids=str)
def test_fixed_order_mean_is_the_kernels_order(r, C, dtype):
    grid = spread_grid(r * C, 2, r, C, dtype)
    got = devox_ops.grid_mean_fixed_order(grid)
    assert got.dtype == torch.float32 and got.shape == (2, C)
    assert torch.equal(got, kernel_model(grid))


def test_the_model_tells_orders_apart():
    """Voxel lane 0 of channel 0 holds 1e20, -1e20 and 1 in that order
    (r = 16, C = 64 f32: 8 blocks of 16 lanes, so a lane's voxels are 128
    apart): ascending, the lane sums to 1; descending, to 0. The fixed
    order is the ascending one."""
    VL = devox_ops.mean_blocks(16 ** 3 * 64 * 4) * devox_ops.MEAN_THREADS // (64 // 4)
    grid = spread_grid(7, 1, 16, 64, torch.float32)
    flat = grid.view(1, -1, 64)
    flat[0, :, 0] = 0.0
    flat[0, 0, 0], flat[0, VL, 0], flat[0, 2 * VL, 0] = 1e20, -1e20, 1.0
    got = devox_ops.grid_mean_fixed_order(grid)
    assert torch.equal(got, kernel_model(grid))
    assert got[0, 0] == np.float32(1.0 / 16 ** 3)
    assert kernel_model(grid, reverse=True)[0, 0] == 0.0


def test_bf16_runs_are_summed_in_f32():
    """Lane 0 of channel 0 holds 2^24 and then 1 (r = 8, C = 8 bf16: one
    block of 256 lanes, so a lane's voxels are 256 apart): the run sums them
    in f32, which drops the 1, while one double add at a time keeps it; the
    fixed order is the run's."""
    grid = torch.zeros(1, 8, 8, 8, 8, dtype=torch.bfloat16)
    flat = grid.view(1, -1, 8)
    VL = devox_ops.MEAN_THREADS
    flat[0, 0, 0], flat[0, VL, 0] = 2.0 ** 24, 1.0
    got = devox_ops.grid_mean_fixed_order(grid)
    assert got[0, 0] == np.float32(2.0 ** 24 / 512)  # 2^24 + 1 rounds to 2^24 in f32
    assert torch.equal(got, kernel_model(grid))
    assert kernel_model(grid, runs=False)[0, 0] == np.float32((2.0 ** 24 + 1) / 512)


@pytest.mark.parametrize("r,C,dtype", MEAN_CASES, ids=str)
def test_fixed_order_mean_matches_the_plain_mean(r, C, dtype):
    """Against the CPU path's f32 mean: both add the same f32 or bf16
    values, one in double and the other in f32 (about 2^-24 per add over
    log2(r^3) levels of pairwise sums), so they agree to 1e-6 of the mean
    absolute value."""
    grid = torch.randn(3, r, r, r, C, generator=torch.Generator().manual_seed(C)).to(dtype)
    got = devox_ops.grid_mean_fixed_order(grid)
    want = devox_ops.grid_mean_plain(grid)
    scale = grid.float().abs().mean().item()
    assert (got - want).abs().max().item() <= 1e-6 * scale


def test_the_cpu_path_returns_the_plain_mean():
    grid = torch.randn(2, 4, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    coords = torch.rand(2, 50, 3, generator=torch.Generator().manual_seed(1)) * 3
    out, mean = devox_ops.trilinear_devoxelize_with_mean(grid, coords, 4)
    assert torch.equal(mean, devox_ops.grid_mean_plain(grid))
    assert torch.equal(out, devox_ops.trilinear_devoxelize_plain(grid, coords, 4))
    assert out.grad_fn is None  # nothing to record: the wrapper skipped the Function


def devoxelize_calls(config):
    """(B, N, r, C) of every devoxelize call of a config's backbone forward."""
    cfg = load_yaml(str(CONFIGS / config))
    with torch.device("meta"):
        plan = build_unet_from_config(cfg).plan
    n, fine, calls = cfg["data"]["npoints"], [], set()
    for stage in plan.sa_stages:
        fine.append(n)
        calls |= {(n, spec.resolution, spec.out_channels) for spec in stage.convs}
        n = stage.sa.num_centers
    for i, stage in enumerate(plan.fp_stages):
        n = fine[-1 - i]
        calls |= {(n, spec.resolution, spec.out_channels) for spec in stage.convs}
    return cfg["training"]["bs"], calls


@pytest.mark.parametrize("config", ["PVDS_PUNet.yaml", "PVDL_SNPP.yaml", "PVDL_ARKIT.yaml"])
def test_devoxelize_kernel_takes_every_config_call(config):
    """K3's shape check passes every devoxelize call of the shipped configs
    (PVDL_SNPP's widths included), at their training batch and at the 73
    patches of a 50k denoise, and refuses what it cannot hold."""
    bs, calls = devoxelize_calls(config)
    assert calls
    for n, r, c in calls:
        for B in (bs, 73):
            devox_ops.check_devoxelize_shape(B, n, r, c)
    for B, N, r, C in ((0, 2048, 32, 64), (1, 0, 32, 64), (1, 2048, 32, 0),
                       (1, 2048, 8, devox_ops.MAX_CHANNELS + 1), (1, 2048, 1024, 2048)):
        with pytest.raises(ValueError, match="trilinear_devoxelize kernel takes"):
            devox_ops.check_devoxelize_shape(B, N, r, C)
