"""Values derived from the weights once per sampler call, not at every step.

Inside :func:`frozen_weights` (``P2PBridge.sample`` opens it: no gradient,
and the weights cannot change between its steps) :func:`once` makes
``make(t)`` once per (tensor, tag) and hands the same result back after: a
Linear's weight cast to the compute dtype, K1's layout of a convolution
weight, the AdaGNs' affines of one conditioning. Outside the scope, or where
a gradient is wanted, it makes it at every call. Each entry keeps its tensor
alive, so no other tensor can take its ``id`` while the scope is open.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch

_local = threading.local()


@contextlib.contextmanager
def frozen_weights():
    """Open the scope (a nested one shares the outer one's values)."""
    outer = getattr(_local, "made", None)
    _local.made = {} if outer is None else outer
    try:
        yield
    finally:
        _local.made = outer


def active() -> bool:
    """True inside the scope with no gradient wanted."""
    return getattr(_local, "made", None) is not None and not torch.is_grad_enabled()


def once(t: torch.Tensor, tag, make: Callable):
    """``make(t)``, made once per scope for (t, tag) where :func:`active`."""
    if not active():
        return make(t)
    key = (id(t), tag)
    hit = _local.made.get(key)
    if hit is None:
        hit = _local.made[key] = (t, make(t))
    return hit[1]
