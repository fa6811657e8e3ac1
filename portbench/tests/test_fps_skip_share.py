"""The reader of ``fps_skip_share.exact`` on made-up records: known counts
give a known share, a trace without the cluster kernel's count gives
nothing, and the tracer finds the counting function through its owner, the
module whose ``_fps_launch`` calls it."""

from __future__ import annotations

import ctypes

import pytest
import torch

from conftest import ROOT
from portbench import harness
from portbench.tracing import Tracer

TARGET = "ops.fps.cluster_skips"


def reader():
    return harness.load_reader(ROOT, "fps_skip_share.exact")


def counted(calls) -> Tracer:
    """A tracer whose span holds ``calls``: [(skipped [B, 16], passes a
    cloud)], recorded as the wrapper records them."""
    t = Tracer("p2p_bridge_tpu_torch")
    span = t.span(TARGET, reader().SPANS[TARGET])
    span.found = True
    span.calls = [(reader()._record(skipped, skipped, passes), 1e-4) for skipped, passes in calls]
    return t


def test_known_counts_give_a_known_share():
    """A 50k and a 10k call: 239 units x 49,999 picks and 112 x 9,999, of
    which the blocks skipped the counts below; the share is their sum over
    the sum of the passes."""
    big = torch.full((1, 16), 700_000, dtype=torch.int64)
    small = torch.full((1, 16), 65_000, dtype=torch.int64)
    t = counted([(big, 239 * 49_999), (small, 112 * 9_999)])
    want = 100 * (16 * 700_000 + 16 * 65_000) / (239 * 49_999 + 112 * 9_999)
    assert reader().read(t) == pytest.approx(want)


def test_a_batch_counts_each_cloud():
    """[B, 16] counts of B clouds: the passes of one cloud times B."""
    skipped = torch.tensor([[10] * 16, [20] * 16], dtype=torch.int64)
    assert reader().read(counted([(skipped, 1_000)])) == pytest.approx(100 * 480 / 2_000)


def test_no_cluster_call_gives_nothing():
    assert reader().read(counted([])) is None
    assert reader().read(Tracer("p2p_bridge_tpu_torch")) is None
    t = counted([(torch.zeros(1, 16, dtype=torch.int64), 100)])
    t.spans[TARGET].found = False  # a program without the function
    assert reader().read(t) is None


def test_the_wrapper_finds_the_count_through_its_owner(monkeypatch):
    """Installed as the benchmark installs it, the span sees the count of
    a cluster FPS call (the kernel's entry points a stand-in here: no card)."""
    from p2p_bridge_tpu_torch import kernels
    from p2p_bridge_tpu_torch.ops import fps as fps_ops

    def entry(restype):
        return lambda *args: 3 if restype is ctypes.c_longlong else 0

    monkeypatch.setattr(kernels, "entry_points",
                        lambda: {n: entry(r) for n, (r, _) in kernels._SIGNATURES.items()})
    monkeypatch.setattr(kernels, "current_stream", lambda device: 0)
    t = Tracer("p2p_bridge_tpu_torch", ranges=False)
    t.span(TARGET, reader().SPANS[TARGET])
    x = torch.zeros(2, fps_ops.CLUSTER_MIN_POINTS, 3)
    with t.wrapped():
        fps_ops._furthest_point_sample_cuda(x, 5)
    assert t.spans[TARGET].found
    (skipped, passes), _ = t.spans[TARGET].calls[0]
    assert skipped.shape == (2, 16) and skipped.dtype == torch.int64
    assert passes == 2 * 3 * 4  # two clouds of 3 units (the stand-in's count), 4 picks after the first
