"""Faults planted in the program's timed path, to show that the check
catches them (the CPU tests) and to read them at a cell's own size
(``portbench.calibrate --fault``): a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced; for a room, a host FPS that does not pick the furthest
points. Each ``plant`` returns the function that takes it out again."""

from __future__ import annotations

import numpy as np
import torch

FAULTS = ("unchanged", "half", "altered")
# a room's host FPS returning the first points instead of the furthest
# ones: what ``fps_cover_excess`` alone can see
SELECTION = "selection"


def _sample_unchanged(self, x_start, *args, **kwargs):
    return {"x_pred": x_start.clone(), "x_start": x_start}


def _sample_half(real):
    def sample(self, x_start, *args, **kwargs):
        out = real(self, x_start, *args, **kwargs)
        half = x_start.shape[0] // 2
        return dict(out, x_pred=torch.cat([out["x_pred"][:half], x_start[half:]]))
    return sample


def _shifted(real, by: float = 0.01):
    def fn(*args, **kwargs):
        out = real(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            return out + torch.tensor([by, 0.0, 0.0], dtype=out.dtype, device=out.device)
        return out + [by, 0.0, 0.0]
    return fn


def plant(driver: str, fault: str):
    """Plant ``fault`` in the path that ``driver`` times -> undo()."""
    from p2p_bridge_tpu_torch import inference, rooms
    from p2p_bridge_tpu_torch.models.p2pb import P2PBridge

    if fault == SELECTION and driver == "rooms":
        old = rooms.bucket_fps
        rooms.bucket_fps = lambda points, n, seed=0: np.arange(min(n, len(points)))
        return lambda: setattr(rooms, "bucket_fps", old)
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    if fault == "unchanged":  # the sampler returns its start state
        where, name, new = P2PBridge, "sample", _sample_unchanged
    elif fault == "half":  # half of the patches sampled, the rest returned as they came
        where, name, new = P2PBridge, "sample", _sample_half(P2PBridge.sample)
    elif driver == "rooms":  # the recomposed room moved by 1 cm
        where, name = rooms.RunningMean, "result"
        new = _shifted(rooms.RunningMean.result)
    else:  # the recombined clouds moved by 0.01 of the unit sphere
        olds = {n: getattr(inference, n) for n in ("recombine_exact", "recombine_bucketed")}
        for n, fn in olds.items():
            setattr(inference, n, _shifted(fn))
        return lambda: [setattr(inference, n, fn) for n, fn in olds.items()]
    old = where.__dict__[name]
    setattr(where, name, new)
    return lambda: setattr(where, name, old)
