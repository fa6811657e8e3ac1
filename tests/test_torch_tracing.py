"""The port's spans (``utils/spans.py``) on the CPU: off without a
profiler, where they are in a trace with one, outputs that do not move
with them, and the functions a benchmark wraps by name still called
through the attribute their callers look up.

Runs use a tiny backbone (random weights from a seed): a 2,000-point room
dense enough that some neighbourhoods are split by the host FPS and some
padded, the same room without its conditioning, and one 600-point object
cloud, each with 2 sampling steps; the cluster FPS's wrapper runs against a
stand-in of its entry points.
"""

import ctypes
import importlib
import json

import numpy as np
import pytest
import torch
import yaml

from p2p_bridge_tpu_torch import denoise_room as room_cli
from p2p_bridge_tpu_torch import inference, kernels, rooms
from p2p_bridge_tpu_torch.config import pvdl_snpp, pvds_punet
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.ops import fps as fps_ops
from p2p_bridge_tpu_torch.utils import spans
from p2p_bridge_tpu_torch.utils.io import read_ply, write_ply

PATCH = 256
FEATS = 5
STEPS = 2
BATCH = 4
TINY_PVD = {"global_embedding_dim": 64, "feat_embed_dim": 8, "attention_heads": 2,
            "channels": [8, 8, 16, 16, 32], "voxel_resolutions": [8, 4, 4, 4],
            "n_sa_blocks": [1, 1, 1, 1], "n_fp_blocks": [1, 1, 1, 1],
            "radius": [0.2, 0.4, 0.8, 1.2], "out_mlp": 16}
ROOM_SPANS = ("rooms.seed", "rooms.patches", "rooms.split_fps", "rooms.batches", "rooms.upload",
              "rooms.features")
SPANS = ROOM_SPANS + ("inference.denoise", "sampler.step")
# the functions a benchmark wraps where their callers look them up, and the
# run that calls each
WRAPPED = {"rooms.create_patches": "room", "rooms.bucket_fps": "room",
           "inference.recombine_exact": "object", "inference.furthest_point_sample": "object",
           "models.pvcnn.furthest_point_sample": "object", "models.pvcnn.conv3d_gn": "object",
           "models.p2pb.P2PBridge.sample": "object", "models.modules.group_norm_act": "object",
           "ops.fps.cluster_skips": "cluster_fps"}


def tiny_config(cfg: dict, features: int) -> dict:
    cfg["data"]["npoints"] = PATCH
    cfg["training"]["amp"] = False
    cfg["model"].update(time_embed_dim=16, extra_feature_channels=features)
    cfg["model"]["PVD"].update(TINY_PVD)
    return cfg


def tiny_bridge(cfg: dict) -> P2PBridge:
    model = init_parameters(build_unet_from_config(cfg), torch.Generator().manual_seed(0))
    return P2PBridge.from_config(cfg, model.eval())


def tiny_room(n: int = 2000):
    """A noisy 1 x 1 m floor: about 560 points in a 0.3 m neighbourhood
    inside it (split), fewer than a patch at its corners (padded)."""
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform(0, 1, (n, 2)), np.zeros((n, 1))], 1)
    pts = (pts + rng.normal(size=(n, 3)) * 0.01).astype(np.float32)
    return pts, rng.normal(size=(n, FEATS)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs():
    """{"room": run(), "object": run(), "bare_room": run(), "cluster_fps":
    run()}: each tiny run, returning its output; the bare room has no
    conditioning."""
    room_bridge = tiny_bridge(tiny_config(pvdl_snpp(), FEATS))
    bare_bridge = tiny_bridge(tiny_config(pvdl_snpp(), 0))
    object_bridge = tiny_bridge(tiny_config(pvds_punet(), 0))
    pts, feats = tiny_room()
    cloud = np.random.default_rng(6).normal(size=(1, 600, 3)).astype(np.float32) * 0.5

    def room():
        return rooms.denoise_room(room_bridge, pts, steps=STEPS, k=1, patch_size=PATCH,
                                  batch_size=BATCH, query_radius=0.3, room_features=feats,
                                  use_feat=True, seed=3)["denoised"]

    def obj():
        return inference.patch_based_denoise_batch(object_bridge, cloud, patch_size=PATCH,
                                                   steps=STEPS, recombine_mode="exact")[0]

    def bare_room():
        return rooms.denoise_room(bare_bridge, pts, steps=STEPS, k=1, patch_size=PATCH,
                                  batch_size=BATCH, query_radius=0.3, seed=3)["denoised"]

    def cluster_fps():
        """The exact recombination's FPS through the cluster kernel's wrapper
        (no card here: its entry points a stand-in that launches nothing)."""
        real = kernels.entry_points, kernels.current_stream
        kernels.entry_points = lambda: {
            name: (lambda *a, r=restype: 1 if r is ctypes.c_longlong else 0)
            for name, (restype, _) in kernels._SIGNATURES.items()}
        kernels.current_stream = lambda device: 0
        try:
            fps_ops._furthest_point_sample_cuda(torch.zeros(1, fps_ops.CLUSTER_MIN_POINTS, 3), 4)
        finally:
            kernels.entry_points, kernels.current_stream = real
        return np.zeros(1)

    return {"room": room, "object": obj, "bare_room": bare_room, "cluster_fps": cluster_fps}


@pytest.fixture(scope="module")
def traced(runs, tmp_path_factory):
    """Each run under a profiler opened with start() / stop(), as the
    benchmark opens one: {run: (output, [(span, start, end)], sample
    calls)}, and the outputs with no profiler."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, run in runs.items():
        calls = []
        real = P2PBridge.sample
        P2PBridge.sample = lambda self, *a, **kw: calls.append(1) or real(self, *a, **kw)
        prof = profile(activities=[ProfilerActivity.CPU])
        try:
            prof.start()
            got = run()
            prof.stop()
        finally:
            P2PBridge.sample = real
        path = tmp_path_factory.mktemp("trace") / f"{name}.json"
        prof.export_chrome_trace(str(path))
        ranges = [(e["name"][len(spans.PREFIX):], e["ts"], e["ts"] + e["dur"])
                  for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(spans.PREFIX)]
        out[name] = (got, ranges, len(calls))
    return out, {name: run() for name, run in runs.items()}


def test_span_without_a_profiler_is_one_shared_no_op():
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span("rooms.seed") is spans.span("sampler.step")
    with spans.span("rooms.seed") as inside:
        assert inside is None


@pytest.mark.parametrize("run", ["room", "object"])
def test_no_range_is_opened_without_a_profiler(runs, run, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert np.isfinite(runs[run]()).all()


def test_a_profiled_room_and_call_hold_every_span_and_no_other(traced):
    out, _ = traced
    assert {n for n, _, _ in out["room"][1]} == set(ROOM_SPANS) | {"sampler.step"}
    assert {n for n, _, _ in out["object"][1]} == {"inference.denoise", "sampler.step"}


@pytest.mark.parametrize("run, inner, outer", [
    ("room", "rooms.split_fps", "rooms.patches"), ("room", "rooms.upload", "rooms.batches"),
    ("room", "sampler.step", "rooms.batches"), ("object", "sampler.step", "inference.denoise"),
    ("room", "rooms.features", "rooms.batches")])
def test_spans_nest(traced, run, inner, outer):
    ranges = traced[0][run][1]
    outers = [(a, b) for n, a, b in ranges if n == outer]
    inners = [(a, b) for n, a, b in ranges if n == inner]
    assert inners and all(any(a <= c and d <= b for a, b in outers) for c, d in inners)


def test_one_step_span_a_sampling_step_and_one_upload_a_batch(traced):
    out, _ = traced
    for run in ("room", "object"):
        _, ranges, calls = out[run]
        names = [n for n, _, _ in ranges]
        assert names.count("sampler.step") == STEPS * calls
    _, ranges, batches = out["room"]
    names = [n for n, _, _ in ranges]
    assert batches > 1 and names.count("rooms.upload") == batches
    assert names.count("rooms.batches") == names.count("rooms.seed") == 1
    assert names.count("rooms.split_fps") >= 1 and names.count("rooms.patches") == 1
    assert out["object"][2] == 1 and names.count("inference.denoise") == 0


def test_one_features_span_a_conditioned_room_and_none_without(traced):
    """The room's conditioning goes to the device once a room, before its
    first batch; a room with none opens no such span."""
    out, _ = traced
    ranges = out["room"][1]
    features = [a for n, a, _ in ranges if n == "rooms.features"]
    assert len(features) == 1
    assert features[0] < min(a for n, a, _ in ranges if n == "rooms.upload")
    bare = {n for n, _, _ in out["bare_room"][1]}
    assert bare == (set(ROOM_SPANS) - {"rooms.features"}) | {"sampler.step"}


@pytest.mark.parametrize("run", ["room", "object"])
def test_outputs_are_equal_with_the_profiler_on_and_off(traced, run):
    out, off = traced
    np.testing.assert_array_equal(out[run][0], off[run])


def _owner(target: str):
    """(the module or class holding the target's last name, that name)."""
    path, attr = target.rsplit(".", 1)
    try:
        return importlib.import_module(f"p2p_bridge_tpu_torch.{path}"), attr
    except ImportError:
        mod, cls = path.rsplit(".", 1)
        return getattr(importlib.import_module(f"p2p_bridge_tpu_torch.{mod}"), cls), attr


@pytest.mark.parametrize("target", list(WRAPPED))
def test_a_wrapped_name_is_called_where_its_caller_looks_it_up(runs, target, monkeypatch):
    owner, attr = _owner(target)
    real = getattr(owner, attr)
    calls = []

    def wrapper(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, attr, wrapper)
    runs[WRAPPED[target]]()
    assert calls, f"{target} was not called through its attribute"


def test_denoise_room_cli_traces_the_room(tmp_path):
    """--profile_dir DIR writes DIR/trace_room.json, with the room engine's
    ranges, beside the prediction."""
    cfg = tiny_config(pvdl_snpp(), FEATS)
    pts, feats = tiny_room()
    (tmp_path / "scene" / "scans").mkdir(parents=True)
    (tmp_path / "scene" / "features").mkdir()
    room = tmp_path / "scene" / "scans" / "iphone.ply"
    write_ply(str(room), pts)
    np.save(tmp_path / "scene" / "features" / "dino_iphone.npy", feats.T)
    run = tmp_path / "runs" / "PVDL_tiny_100"
    run.mkdir(parents=True)
    (run / "opt.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    torch.save({"model": tiny_bridge(cfg).model.state_dict(), "ema": None}, run / "model.pt")
    out = room_cli.main(["--room_path", str(room), "--model_path", str(run), "--device", "cpu",
                         "--steps", str(STEPS), "--k", "1", "--batch_size", str(BATCH),
                         "--profile_dir", str(tmp_path / "trace")])
    assert read_ply(out)["points"].shape == pts.shape
    events = json.loads((tmp_path / "trace" / "trace_room.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {n for n in names if n.startswith("p2pb.rooms.")} == {"p2pb." + s for s in ROOM_SPANS}
    assert not torch._C._autograd._profiler_enabled()
