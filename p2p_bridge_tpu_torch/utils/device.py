"""The device a host-facing entry point runs on, and its profiler."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (a name or torch.device) as a torch.device; a CUDA device
    where no card is available raises: nothing falls back to the CPU
    unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but no CUDA device is available")
    return device


def profiler(device: torch.device):
    """A torch.profiler recording the host and, on a card, the device; the
    caller starts, stops and exports it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)
