"""The frozen arithmetic: the model FLOP counter and the roofline bounds."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, tiny
from portbench import bounds
from portbench.flops import forward_flops
from portbench.reference.model import Unet
from portbench.weights import make_state_dict


def config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_pvds_punet_at_the_object_batch():
    """73 patches of a 50k cloud: 3.5237 TFLOP a forward, linear in B."""
    cfg = config("PVDS_PUNet")
    assert forward_flops(cfg, 73) == 73 * forward_flops(cfg, 1)
    assert forward_flops(cfg, 73) == pytest.approx(3.5237e12, rel=1e-4)


def test_pvdl_snpp_at_the_room_batch():
    assert forward_flops(config("PVDL_SNPP"), 32) == pytest.approx(1.01896e13, rel=1e-5)


@pytest.mark.parametrize("name,extra", [("PVDS_PUNet", 0), ("PVDL_SNPP", 12)])
def test_counter_equals_torch_flop_counter(name, extra):
    """Convolutions, matrix products and the attention's contractions of
    the plain forward, counted by torch.utils.flop_counter, at TINY."""
    cfg = tiny(name, extra)
    cfg["data"]["npoints"] = 512
    model = Unet(cfg).eval()
    model.load_state_dict(make_state_dict(cfg, 0, "cpu"))
    cond = torch.randn(2, 512, extra) if extra else None
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.randn(2, 512, 3) * 0.5, torch.tensor([3.0, 5.0]), cond)
    assert forward_flops(cfg, 2) == counter.get_total_flops()


def test_fps_bound_of_the_exact_recombination():
    """49,999 picks from the 149,504 denoised points of a 50k cloud:
    1.116 ms at 67 TFLOP/s."""
    assert bounds.fps_bound_s(1, 149_504, 50_000) * 1e3 == pytest.approx(1.116, abs=5e-4)


def test_conv_bound():
    """The larger of operations over the dtype's peak and bytes over HBM."""
    ops = 2.0 * 73 * 32 ** 3 * 27 * 64 * 64
    assert bounds.conv_bound_s(73, 32, 64, 64, 2) == pytest.approx(ops / 989e12)
    nbytes = (8 ** 3 * 8 + 27 * 16) * 4
    assert bounds.conv_bound_s(1, 8, 4, 4, 4) == pytest.approx(
        max(2.0 * 8 ** 3 * 27 * 16 / 67e12, nbytes / 3.35e12))
