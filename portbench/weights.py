"""Random weights of a configuration, made on the device from the seed.

One float32 buffer of every parameter is drawn uniform in [-1, 1) by one
call of a ``torch.Generator`` on the device, then cut into the
state_dict's tensors and scaled as PyTorch initialises them: Linear and
Conv3d weights and biases within +-1 / sqrt(fan_in) (kaiming-uniform with
a = sqrt(5)), GroupNorm scales 1 and shifts 0, each AdaGN's conditioning
bias [1, ..., 0, ...] (identity scale, no shift). The head's last Linear
is scaled further by ``HEAD_SCALE``: random weights otherwise make the
sampler's steps move the points by the size of the cloud, and a denoiser
moves them by the noise (about 1% of the cloud). Both the program and the
reference load the result.
"""

from __future__ import annotations

from typing import Dict

import torch

from .reference.model import Unet

HEAD = "classifier.2."
HEAD_SCALE = 0.02


def parameter_shapes(cfg: dict) -> Dict[str, torch.Size]:
    """name -> shape of every parameter of the configuration's model."""
    with torch.device("meta"):
        model = Unet(cfg)
    return {k: v.shape for k, v in model.state_dict().items()}


def make_state_dict(cfg: dict, seed: int, device, head_scale: float = HEAD_SCALE) -> dict:
    shapes = parameter_shapes(cfg)
    total = sum(s.numel() for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=gen)
    out, offset = {}, 0
    for name, shape in shapes.items():
        t = flat[offset:offset + shape.numel()].view(shape)
        offset += shape.numel()
        stem, kind = name.rsplit(".", 1)
        weight = shapes.get(stem + ".weight")
        if weight is not None and len(weight) >= 2:  # Linear / Conv3d
            t.mul_(weight[1:].numel() ** -0.5 * (head_scale if name.startswith(HEAD) else 1.0))
            if stem.endswith(".emd") and kind == "bias":  # AdaGN: identity affine
                half = shape[0] // 2
                t[:half] = 1.0
                t[half:] = 0.0
        else:  # GroupNorm
            t.fill_(1.0 if kind == "weight" else 0.0)
        out[name] = t
    return out
