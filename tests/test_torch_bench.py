"""The port's bench (p2p_bridge_tpu_torch/bench.py) and its FLOP counter
(p2p_bridge_tpu_torch/utils/flops.py) on the CPU, no card: the counter
against torch.utils.flop_counter on the plain forward, the JSON line's
keys and arithmetic, the profiler-window readers on a made-up trace, and
the refusal to run without a card."""

import copy

import numpy as np
import pytest
import torch
from test_torch_parity import TINY
from torch.utils.flop_counter import FlopCounterMode

from p2p_bridge_tpu_torch import bench
from p2p_bridge_tpu_torch.config import pvds_punet
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.utils.flops import forward_flops

KEYS = {"metric", "value", "unit", "best_points_per_sec", "device_points_per_sec", "mfu",
        "device_mfu", "room_points_per_sec", "device"}


@pytest.mark.parametrize("attention", ["linear", "flash"])
@pytest.mark.parametrize("variant", ["global_embed", "no_global_embed", "conditioned"])
def test_flop_count_equals_torch_flop_counter(attention, variant):
    """At TINY widths on 512 points (2 at the bottleneck: over one point
    einsum multiplies without a matmul, which the counter does not see)
    the count equals FlopCounterMode's over the plain forward exactly
    (tolerance 0): convolutions, matmuls and the attention's bmms are all
    either counts."""
    cfg = copy.deepcopy(TINY)
    cfg["data"]["npoints"] = 512
    pvd = cfg["model"]["PVD"]
    pvd["attention_type"] = attention
    pvd["use_global_embedding"] = variant != "no_global_embed"
    cond = None
    if variant == "conditioned":  # PVDL's form: features embedded to feat_embed_dim
        cfg["model"]["extra_feature_channels"] = 12
        cond = torch.randn(2, 512, 12)
    model = build_unet_from_config(cfg).eval()
    init_parameters(model, torch.Generator().manual_seed(0))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.randn(2, 512, 3) * 0.5, torch.tensor([3.0, 5.0]), cond)
    assert forward_flops(cfg, 2) == counter.get_total_flops()


def test_flop_count_of_the_bench():
    """PVDS_PUNet at B = 73: 3.5237 TFLOP a forward, linear in B."""
    cfg = pvds_punet()
    assert forward_flops(cfg, 73) == 73 * forward_flops(cfg, 1)
    assert forward_flops(cfg, 73) == pytest.approx(3.5237e12, rel=1e-4)


def test_the_bench_line_has_its_keys_and_arithmetic():
    device = {"name": "card", "power_limit_w": 700.0, "count": 1}
    line = bench.result_line(steady_s=0.5, best_s=0.8, device_s=0.25, model_flops=1e14,
                             room_best_s=2.0, overlap_ms=1.5, host_syncs=0, device=device)
    assert KEYS <= set(line)
    assert line["metric"] == "punet50k_denoise_points_per_sec"
    assert line["unit"] == "points/sec/gpu" and "vs_baseline" not in line
    assert line["value"] == bench.N_OBJECTS * bench.N_POINTS / 0.5
    assert line["best_points_per_sec"] == 200_000 / 0.8
    assert line["device_points_per_sec"] == 200_000 / 0.25
    assert line["mfu"] == pytest.approx(1e14 / 0.5 / 989e12)
    assert line["device_mfu"] == pytest.approx(1e14 / 0.25 / 989e12)
    assert line["room_points_per_sec"] == 32 * 4096 / 2.0
    assert line["device"] == device
    assert bench.parse_args([]).seed == 0 and bench.parse_args(["--seed", "3"]).seed == 3
    clouds = bench.object_clouds(0)
    assert clouds.shape == (4, 50_000, 3) and clouds.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(clouds, axis=-1).max(axis=1), 1.0, rtol=1e-6)


def test_the_bench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def launch(ts, corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def test_the_profiler_window_readers():
    """A made-up trace: 2 opening spins, call 0 (kernels a, b), a marker
    launched at 30 us while b runs to 40, call 1 (kernel c); a device
    synchronise inside the window and one after it."""
    events = [
        kernel("spin_kernel", 0, 2, 1), kernel("spin_kernel", 3, 2, 2),
        {"ph": "X", "cat": "user_annotation", "name": bench.WINDOW, "ts": 6, "dur": 60},
        kernel("a", 10, 10, 3), kernel("b", 25, 15, 4), launch(30, 5),
        kernel("spin_kernel", 41, 1, 5), kernel("c", 43, 5, 6),
        launch(50, 7, "cudaDeviceSynchronize"), launch(70, 8, "cudaDeviceSynchronize"),
    ]
    spans = bench.device_spans(events)
    assert [s[0] for s in spans] == ["a", "b", "c"]
    assert bench.busy_seconds(spans) == pytest.approx(30e-6)
    lead_ms, syncs = bench.pipelined_overlap(events)
    assert lead_ms == pytest.approx(0.010) and syncs == 1
