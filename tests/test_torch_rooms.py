"""The port's room path (rooms.py and the denoise_room CLI) against the
JAX package on the CPU.

The host work (seeding, patching, normalisation, recomposition) is numpy on
both sides and must agree exactly. Sampling runs a small conditioned
backbone (TINY widths, 12 feature channels embedded to 8, the global
embedding on) with the same weights, carried by ``load_jax_params``; its
head is scaled by 0.01 so each reverse step moves a patch a little, as a
trained denoiser's does (tests/test_torch_model.py test_sample_matches_jax).
Outputs agree within GLOBAL_EMBED_TOL x max(1, max|out|), the tolerance of
the conditioned forward with the global embedding. Without the overlap
average the denoised patches are FPS-sampled back to N points, and FPS is
discontinuous: there every point of the port's output must lie within
twice that tolerance of one of the denoised points of the JAX package (the
convention of tests/test_torch_inference.py). The outlier filter is
discontinuous too: the two may drop different points only at near ties,
and the points whose kept entries agree are compared.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial import cKDTree
from test_torch_model import GLOBAL_EMBED_TOL, tiny

from p2p_bridge_tpu import rooms as jax_rooms
from p2p_bridge_tpu.models.p2pb import P2PBridge as JaxBridge
from p2p_bridge_tpu.models.unet_pvc import build_unet_from_config as jax_build
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu.utils.torch_compat import convert_torch_state_dict
from p2p_bridge_tpu_torch import denoise_room as room_cli
from p2p_bridge_tpu_torch import rooms
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.parallel.mesh import DataMesh, shard_batch
from p2p_bridge_tpu_torch.utils.io import read_ply, write_ply
from p2p_bridge_tpu_torch.weights import load_jax_params

FEATS = 12
PATCH = 256
BATCH = 4
RADIUS = 0.3
TOL = GLOBAL_EMBED_TOL


def room_config():
    """TINY, conditioned on FEATS feature channels, as a ScanNet++ run."""
    cfg = tiny(True)
    cfg["model"]["extra_feature_channels"] = FEATS
    cfg["model"]["PVD"]["feat_embed_dim"] = 8
    cfg["data"] = {"npoints": PATCH, "dataset": "ScanNetPP", "point_features": "dino",
                   "use_rgb_features": False}
    return cfg


def synthetic_room(seed, n=6000):
    """A 2 x 2 m floor with a 0.6 m box on it, noisy; colours and FEATS
    feature channels per point. The floor's density (about 1,100 points a
    square metre) gives radius-0.3 neighbourhoods both below PATCH points
    (padded) and above it (split)."""
    rng = np.random.default_rng(seed)
    n_box = n // 4
    floor = np.concatenate([rng.uniform(0, 2, (n - n_box, 2)), np.zeros((n - n_box, 1))], 1)
    box = rng.uniform(-0.3, 0.3, (n_box, 3))
    axis = rng.integers(0, 3, n_box)
    box[np.arange(n_box), axis] = np.sign(box[np.arange(n_box), axis]) * 0.3
    box += [1.0, 1.0, 0.3]
    pts = np.concatenate([floor, box]) + rng.normal(size=(n, 3)) * 0.01
    pts = rng.permutation(pts).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    feats = rng.normal(size=(n, FEATS)).astype(np.float32)
    return pts, colors, feats


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The backbone here is tiny (patches of 256 points at TINY widths): its
    ops take microseconds, and CPU threads cost more than they give,
    most of all beside other test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def bridges():
    """(JAX bridge, its variables, the port's bridge, the config) over the
    same weights of the conditioned backbone: PyTorch's default
    initialisation from a seed, taken into the flax tree by the JAX
    package's converter (its shapes from jax.eval_shape, which compiles
    nothing), head scaled by 0.01, and carried into the port by
    load_jax_params."""
    cfg = room_config()
    fmodel = jax_build(Config(cfg))
    template = jax.eval_shape(lambda: fmodel.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, PATCH, 3)), jnp.zeros((1,)),
        jnp.zeros((1, PATCH, FEATS)), True))
    seed_model = init_parameters(build_unet_from_config(cfg), torch.Generator().manual_seed(0))
    params = jax.tree.map(np.asarray, convert_torch_state_dict(seed_model.state_dict(), template))
    head = params["params"]["classifier_out"]
    head["kernel"] = head["kernel"] * np.float32(0.01)
    head["bias"] = head["bias"] * np.float32(0.01)
    tmodel = build_unet_from_config(cfg).eval()
    load_jax_params(tmodel, params)
    return (JaxBridge.from_config(Config(cfg), fmodel), jax.tree.map(jnp.asarray, params),
            P2PBridge.from_config(cfg, tmodel), cfg)


def within(got, want, factor=1.0):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    bound = factor * TOL * max(1.0, np.abs(np.asarray(want)).max())
    assert err <= bound, (err, bound)


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_create_patches_equals_jax():
    """Empty, padded, exactly full and split neighbourhoods, with colours
    and features: the same patches, indices and cuts. A split yields
    n // PATCH + 1 identical patches, as in the JAX package (its
    bucket_fps ignores the seed)."""
    pts, colors, feats = synthetic_room(0, 2000)
    rng = np.random.default_rng(1)
    hoods = [np.arange(0), rng.choice(2000, 10, replace=False),
             rng.choice(2000, PATCH, replace=False), rng.choice(2000, 700, replace=False),
             np.arange(PATCH + 1)]
    for c, f in ((None, None), (colors, feats)):
        got = rooms.create_patches(pts, PATCH, hoods, c, f, np.random.default_rng(2))
        want = jax_rooms.create_patches(pts, PATCH, hoods, c, f, np.random.default_rng(2))
        assert_same(got, want)
    xyz, _, _, idxs, cuts = got
    assert cuts.tolist() == [10] + [PATCH] * (2 + 3 + 2)
    for a, b in ((1, 2), (3, 4), (3, 5), (6, 7)):  # the splits' duplicates
        np.testing.assert_array_equal(idxs[a], idxs[b])
        np.testing.assert_array_equal(xyz[a], xyz[b])


def test_running_mean_equals_jax():
    pts, _, _ = synthetic_room(3, 500)
    rng = np.random.default_rng(4)
    got, want = rooms.RunningMean(pts), jax_rooms.RunningMean(pts)
    for _ in range(3):
        patches = rng.normal(size=(5, 64, 3)).astype(np.float32)
        idxs = rng.integers(0, 400, (5, 64))  # points 400-499 never updated
        cuts = rng.integers(0, 65, 5)
        got.update(patches, idxs, cuts)
        want.update(patches, idxs, cuts)
    np.testing.assert_array_equal(got.sums, want.sums)
    np.testing.assert_array_equal(got.counts, want.counts)
    out = got.result(np.random.default_rng(5))
    np.testing.assert_array_equal(out, want.result(np.random.default_rng(5)))
    assert np.isfinite(out).all() and not np.isin(out[400:], pts[400:]).all()


def test_remove_outliers_equals_jax():
    rng = np.random.default_rng(6)
    ref = rng.normal(size=(3, 200, 3)).astype(np.float32)
    gen = ref + rng.normal(size=ref.shape).astype(np.float32) * 0.01
    gen[:, 17] += 5.0  # planted outliers
    for n_out in (0, 1, 2):
        kept, mask = rooms.remove_outliers(gen, ref, n_out, "cpu")
        want_kept, want_mask = jax_rooms.remove_outliers(gen, ref, n_out)
        np.testing.assert_array_equal(mask, want_mask)
        np.testing.assert_array_equal(kept, want_kept)
        assert kept.shape == (3, 200 - n_out, 3)
    assert not mask[:, 17].any()


@pytest.fixture
def filters(monkeypatch):
    """{"port": [...], "jax": [...]}: each outlier filter call's (denoised
    and input patches, normalised; keep mask), recorded on both sides."""
    out = {"port": [], "jax": []}
    for side, module in (("port", rooms), ("jax", jax_rooms)):
        def spy(gen, ref, *args, fn=module.remove_outliers, side=side):
            kept, mask = fn(gen, ref, *args)
            out[side].append((gen, ref, mask))
            return kept, mask
        monkeypatch.setattr(module, "remove_outliers", spy)
    return out


def assert_filters_part_only_at_near_ties(filters):
    """Each filter drops a patch's 1% of points farthest from the input. A
    point's distance moves by at most its own move eps between the
    frameworks, so they may keep different points only within 2 eps of
    the cut (a near tie). -> the rows whose masks agree, per call."""
    agree = []
    for (gen, ref, mask), (want_gen, _, want_mask) in zip(filters["port"], filters["jax"]):
        assert mask.shape == want_mask.shape
        for i in np.flatnonzero((mask != want_mask).any(axis=1)):
            eps = np.linalg.norm(gen[i] - want_gen[i], axis=1).max()
            d = cKDTree(ref[i]).query(want_gen[i])[0]
            cut = np.sort(d)[-int(PATCH * 0.01)]
            assert np.abs(d[mask[i] != want_mask[i]] - cut).max() <= 2 * eps + 1e-6
        agree.append((mask == want_mask).all(axis=1))
    assert len(filters["port"]) == len(filters["jax"]) > 0
    return agree


def test_denoise_patch_batch_equals_jax(bridges, filters):
    """Plain (with the chain) and with the outlier filter: the keep masks
    part only at near ties, and the kept points of the patches whose masks
    agree are within the tolerance."""
    fb, variables, tb, _ = bridges
    rng = np.random.default_rng(7)
    pts, _, feats = synthetic_room(8, 3000)
    sel = rng.choice(3000, (BATCH, PATCH))
    xyz, f = pts[sel], feats[sel]
    got, chain = rooms.denoise_patch_batch(tb, xyz, 2, None, f, False, True, return_steps=True)
    want, want_chain = jax_rooms.denoise_patch_batch(fb, variables, xyz, 2, None, f, False, True,
                                                     return_steps=True)
    within(got, want)
    assert chain.shape == np.asarray(want_chain).shape == (2, BATCH, PATCH, 3)
    within(chain, want_chain)
    got, mask = rooms.denoise_patch_batch(tb, xyz, 2, None, f, False, True, filtering=True)
    want, want_mask = jax_rooms.denoise_patch_batch(fb, variables, xyz, 2, None, f, False, True,
                                                    filtering=True)
    (agree,) = assert_filters_part_only_at_near_ties(filters)
    assert got.shape == (BATCH, PATCH - int(PATCH * 0.01), 3) and agree.any()
    within(got[agree], want[agree])


MODES = {  # with averaging the chain's average comes along: "denoised" and "steps"
    "average_steps": {"return_steps": True},
    "filter_outliers": {"filter_outliers": True},
    "fps": {"average_predictions": False},
}


def room_kwargs(**extra):
    """denoise_room's arguments here: k = 4 (the CLI's default), 2 steps."""
    return dict(steps=2, k=4, patch_size=PATCH, batch_size=BATCH, query_radius=RADIUS,
                use_feat=True, seed=3, **extra)


def room_patches(pts, feats):
    """The patches of denoise_room(**room_kwargs()) as the JAX package cuts
    them: (xyz, feats, idxs, cuts)."""
    seeds = jax_rooms.bucket_fps(pts, int(np.ceil(len(pts) / PATCH)) * 4, seed=3)
    hoods = [np.asarray(i, np.int64)
             for i in cKDTree(pts).query_ball_point(pts[seeds], r=RADIUS, workers=-1)]
    xyz, _, f, idxs, cuts = jax_rooms.create_patches(pts, PATCH, hoods, None, feats,
                                                     np.random.default_rng(3))
    return xyz, f, idxs, cuts


def kept_counts(masks, idxs, cuts, n):
    """How many kept patch entries each room point averages, from the
    outlier filter's keep masks of each batch (padding rows left out)."""
    counts = np.zeros(n, np.int64)
    for mask, idx, cut in zip(np.concatenate(masks)[:len(idxs)], idxs, cuts):
        np.add.at(counts, idx[:cut][mask[:cut]], 1)
    return counts


@pytest.mark.parametrize("mode", list(MODES))
def test_denoise_room_matches_jax(bridges, mode, filters):
    fb, variables, tb, _ = bridges
    pts, _, feats = synthetic_room(9)
    kw = room_kwargs(room_features=feats, **MODES[mode])
    got = rooms.denoise_room(tb, pts, **kw)
    want = jax_rooms.denoise_room(fb, variables, pts, **kw)
    assert got.keys() == want.keys()
    assert got["denoised"].shape == pts.shape and np.isfinite(got["denoised"]).all()
    if mode == "average_steps":
        for key in want:
            within(got[key], want[key])
    elif mode == "filter_outliers":
        # where the filters part (near ties) a point's average differs by
        # O(its move), or it goes unsampled on one side (filled at random):
        # every point whose kept entries agree must agree within the
        # tolerance
        assert_filters_part_only_at_near_ties(filters)
        _, _, idxs, cuts = room_patches(pts, feats)
        counts = kept_counts([f[2] for f in filters["port"]], idxs, cuts, len(pts))
        want_counts = kept_counts([f[2] for f in filters["jax"]], idxs, cuts, len(pts))
        same = (counts == want_counts) & (counts > 0)
        assert same.mean() > 0.9, same.mean()
        within(got["denoised"][same], want["denoised"][same])
    else:
        # every point is one of the JAX package's denoised patch points
        flat = jax_denoised_patches(fb, variables, pts, feats)
        nearest = torch.cdist(torch.from_numpy(got["denoised"]), torch.from_numpy(flat),
                              compute_mode="donot_use_mm_for_euclid_dist").min(1).values
        assert nearest.max().item() <= 2 * TOL * max(1.0, np.abs(flat).max())


def jax_denoised_patches(fb, variables, pts, feats):
    """The JAX package's denoised patches of denoise_room(**room_kwargs())
    before its FPS, [P * PATCH, 3]: its patches in padded batches, step for
    step."""
    xyz, f, _, _ = room_patches(pts, feats)
    out = []
    for s in range(0, len(xyz), BATCH):
        sel = np.minimum(np.arange(s, s + BATCH), min(s + BATCH, len(xyz)) - 1)
        d, _ = jax_rooms.denoise_patch_batch(fb, variables, xyz[sel], 2, None, f[sel], False,
                                             True)
        out.append(d[:min(BATCH, len(xyz) - s)].reshape(-1, 3))
    return np.concatenate(out)


def test_denoise_room_pads_the_last_batch_and_needs_a_mesh_that_divides_it(bridges,
                                                                          monkeypatch):
    """Every batch the sampler sees has batch_size patches (the last one
    padded with repeats), as in the JAX package; a mesh whose ranks do not
    divide batch_size raises, as the JAX package's does."""
    _, _, tb, _ = bridges
    pts, _, feats = synthetic_room(10, 1500)
    shapes = []
    sample = tb.sample

    def spy(x, cond=None, **kw):
        shapes.append((tuple(x.shape), tuple(cond.shape)))
        return sample(x, cond, **kw)

    monkeypatch.setattr(tb, "sample", spy)
    rooms.denoise_room(tb, pts, **room_kwargs(room_features=feats))
    assert shapes and set(shapes) == {((BATCH, PATCH, 3), (BATCH, PATCH, FEATS))}
    with pytest.raises(ValueError, match="divide"):
        rooms.denoise_room(tb, pts, mesh=DataMesh(0, 3, torch.device("cpu"), "gloo"),
                           **room_kwargs())



# ---------------------------------------------- the conditioning on the device
# (room colours, room features, use_rgb, use_feat) of synthetic_room(10, 3000):
# 50 patches, padded and split, the last batch of 4 padded
def conditioning_case(name):
    pts, colors, feats = synthetic_room(10, 3000)
    f_order = np.ascontiguousarray(feats.T).T  # ScanNet++'s [C, N] file through .T
    return pts, {
        "f_order_f32": (None, f_order, False, True),
        "c_order_f32": (None, feats, False, True),
        "f16": (None, feats.astype(np.float16), False, True),
        "rgb_and_feat": (colors, f_order, True, True),
        # a column slice of [xyz | rgb], neither C- nor F-ordered; features not used
        "rgb_only": (np.concatenate([pts, colors], 1)[:, 3:], feats, True, False),
        "none": (colors, feats, False, False),
    }[name]


@pytest.fixture
def sampled(bridges, monkeypatch):
    """Spies on the port's room path, with the backbone left out (the
    sampler returns its start): {"cond": each sample call's conditioning
    (numpy, or None), "patches": each create_patches call's (args, kwargs,
    a copy of its generator), "uploads": each device_rows call's array}."""
    _, _, tb, _ = bridges
    out = {"cond": [], "patches": [], "uploads": []}

    def sample(x, cond=None, **kw):
        out["cond"].append(None if cond is None else cond.numpy())
        return {"x_pred": x}

    def create_patches(*args, fn=rooms.create_patches, **kwargs):
        out["patches"].append((args, kwargs, copy.deepcopy(kwargs.get("rng"))))
        return fn(*args, **kwargs)

    def device_rows(a, *args, fn=rooms.device_rows):
        out["uploads"].append(a)
        return fn(a, *args)

    monkeypatch.setattr(tb, "sample", sample)
    monkeypatch.setattr(rooms, "create_patches", create_patches)
    monkeypatch.setattr(rooms, "device_rows", device_rows)
    return out


def host_conditioning(pts, patches_call, colors, feats, use_rgb, use_feat, mesh=None):
    """Each batch's conditioning as the host gathered it before it moved to
    the device: create_patches (the JAX package's, which the port's equals)
    with the room's colours and features, each padded batch's rows
    [rgb | feat] as denoise_patch_batch concatenated them (this rank's rows
    with a mesh)."""
    args, _, rng = patches_call
    _, rgb, f, idxs, _ = jax_rooms.create_patches(pts, args[1], args[2], colors, feats, rng)
    out = []
    for s in range(0, len(idxs), BATCH):
        sel = np.minimum(np.arange(s, s + BATCH), min(s + BATCH, len(idxs)) - 1)
        if mesh is not None:
            sel = shard_batch(sel, mesh)
        parts = [a[sel] for a, used in ((rgb, use_rgb), (f, use_feat)) if used and a is not None]
        out.append(np.concatenate(parts, -1) if parts else None)
    return out, len(idxs)


@pytest.mark.parametrize("case", ["f_order_f32", "c_order_f32", "f16", "rgb_and_feat",
                                  "rgb_only", "none"])
def test_every_batch_is_conditioned_as_the_host_gathered_it(sampled, bridges, case):
    """F- and C-ordered f32 features, f16 features, colours with features,
    colours alone (a strided view) and no conditioning: every batch the
    sampler sees, the padded last one too, holds the rows the host gather
    gave, bit for bit and in float32. create_patches gets no conditioning,
    and each used channel is copied to the device once a room."""
    _, _, tb, _ = bridges
    pts, (colors, feats, use_rgb, use_feat) = conditioning_case(case)
    kw = room_kwargs(room_colors=colors, room_features=feats)
    kw.update(use_rgb=use_rgb, use_feat=use_feat)
    for _ in range(2):  # two rooms
        rooms.denoise_room(tb, pts, **kw)
    assert len(sampled["patches"]) == 2
    for args, kwargs, _ in sampled["patches"]:
        assert len(args) == 3 and set(kwargs) == {"rng"}
    want, n_patches = host_conditioning(pts, sampled["patches"][0], colors, feats,
                                        use_rgb, use_feat)
    assert n_patches % BATCH  # the last batch is padded
    assert len(sampled["cond"]) == 2 * len(want)
    for got, w in zip(sampled["cond"], want + want):
        if w is None:
            assert got is None
        else:
            assert got.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(got, w)
    used = [a for a, u in ((colors, use_rgb), (feats, use_feat)) if u]
    assert len(sampled["uploads"]) == 2 * len(used)
    for got, w in zip(sampled["uploads"], used + used):
        assert got is w


@pytest.mark.parametrize("rank", [0, 1])
def test_a_mesh_rank_is_conditioned_with_its_rows(sampled, bridges, rank, monkeypatch):
    """A rank of a 2-rank gloo mesh samples its half of every padded batch,
    conditioned with those rows' features (the gather of the predictions
    stood in for: the predictions are not compared here)."""
    _, _, tb, _ = bridges
    pts, (_, feats, _, _) = conditioning_case("f_order_f32")
    mesh = DataMesh(rank, 2, torch.device("cpu"), "gloo")
    monkeypatch.setattr(rooms, "gather_patch_batch",
                        lambda mesh, d, chain: (np.concatenate([d, d]), chain))
    rooms.denoise_room(tb, pts, mesh=mesh, **room_kwargs(room_features=feats))
    want, _ = host_conditioning(pts, sampled["patches"][0], None, feats, False, True, mesh)
    assert len(sampled["cond"]) == len(want) and len(sampled["uploads"]) == 1
    for got, w in zip(sampled["cond"], want):
        assert got.shape == (BATCH // 2, PATCH, FEATS)
        np.testing.assert_array_equal(got, w)


def test_denoise_patch_batch_takes_the_conditioning_from_the_device_or_the_host(bridges):
    """The same batch conditioned by the host's numpy rows and by a room's
    RoomConditioning with the batch's indices: the same sample."""
    _, _, tb, _ = bridges
    pts, colors, feats = synthetic_room(13, 2000)
    idxs = np.random.default_rng(14).choice(2000, (BATCH, PATCH))
    f16 = feats.astype(np.float16)
    with torch.no_grad():
        host = rooms.denoise_patch_batch(tb, pts[idxs], 1, None, f16[idxs].astype(np.float32),
                                         False, True)[0]
        cond = rooms.RoomConditioning(torch.device("cpu"), f16)
        device = rooms.denoise_patch_batch(tb, pts[idxs], 1, cond=(cond, idxs))[0]
    np.testing.assert_array_equal(device, host)


def test_denoise_room_on_cuda_requires_the_native_runtime(monkeypatch):
    """A bridge on a CUDA device never takes the numpy fallback: with no
    native library denoise_room raises before any work (the CPU keeps the
    fallback, as test_torch_runtime.py checks)."""
    param = type("Param", (), {"device": torch.device("cuda", 0)})()
    bridge = type("Bridge", (), {})()
    bridge.model = type("Model", (), {"parameters": lambda self: iter([param])})()
    monkeypatch.setattr(rooms, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native host runtime"):
        rooms.denoise_room(bridge, np.zeros((10, 3), np.float32))


# ---------------------------------------------------------------- the CLIs
@pytest.fixture
def scene(tmp_path, bridges):
    """A ScanNet++ scene (scans/iphone.ply, features/dino_iphone.npy in
    its [C, N] layout) and a run directory (opt.yaml, model.pt)."""
    _, _, tb, cfg = bridges
    pts, colors, feats = synthetic_room(11, 3000)
    (tmp_path / "scene" / "scans").mkdir(parents=True)
    (tmp_path / "scene" / "features").mkdir()
    write_ply(str(tmp_path / "scene" / "scans" / "iphone.ply"), pts, colors=colors)
    np.save(tmp_path / "scene" / "features" / "dino_iphone.npy", feats.T)
    run = tmp_path / "runs" / "PVDL_tiny_100"
    run.mkdir(parents=True)
    (run / "opt.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    torch.save({"model": tb.model.state_dict(), "ema": None}, run / "model.pt")
    return tmp_path / "scene", run


def test_denoise_room_cli_on_cpu(scene, bridges):
    """The CLI's prediction (named as the root CLI names it) equals
    denoise_room on the same room, features and weights; --intermediate
    writes the steps."""
    _, _, tb, cfg = bridges
    scene_dir, run = scene
    room = str(scene_dir / "scans" / "iphone.ply")
    out = room_cli.main(["--room_path", room, "--model_path", str(run), "--device", "cpu",
                         "--steps", "2", "--k", "1", "--batch_size", str(BATCH),
                         "--intermediate"])
    assert out.endswith("predictions/P2SB/runs_iphone_100_2_ema.ply")
    pts, colors, feats = room_cli.load_room_files(room, "dino_iphone", cfg["data"])
    assert feats.shape == (3000, FEATS)
    want = rooms.denoise_room(tb, pts.astype(np.float32), steps=2, k=1, patch_size=PATCH,
                              batch_size=BATCH, query_radius=0.3, room_colors=colors,
                              room_features=feats, use_feat=True, return_steps=True, seed=42)
    got = read_ply(out)
    np.testing.assert_array_equal(got["points"], want["denoised"])
    np.testing.assert_array_equal(got["colors"], colors)
    for i in range(2):
        step = read_ply(out.rsplit(".", 1)[0] + f"_step_{i}.ply")["points"]
        np.testing.assert_array_equal(step, want["steps"][i])
    # an existing prediction is kept unless --overwrite
    written = os.stat(out).st_mtime_ns
    assert room_cli.main(["--room_path", room, "--model_path", str(run), "--device", "cpu",
                          "--steps", "2"]) == out
    assert os.stat(out).st_mtime_ns == written


def test_denoise_room_cli_refusals(scene, monkeypatch):
    scene_dir, run = scene
    room = str(scene_dir / "scans" / "iphone.ply")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        room_cli.main(["--room_path", room, "--model_path", str(run)])


def test_room_files_take_the_arkit_layout(scene):
    """ARKitScenes features are [N, C] on disk; no features, no conditioning."""
    scene_dir, _ = scene
    room = str(scene_dir / "scans" / "iphone.ply")
    snpp = room_cli.load_room_files(room, "dino_iphone", {"dataset": "ScanNetPP",
                                                          "point_features": "dino"})[2]
    np.save(scene_dir / "features" / "dino_iphone.npy", snpp)
    arkit = room_cli.load_room_files(room, "dino_iphone", {"dataset": "ArKitPP",
                                                           "point_features": "dino"})[2]
    np.testing.assert_array_equal(arkit, snpp)
    assert room_cli.load_room_files(room, "missing", {"dataset": "ScanNetPP",
                                                      "point_features": "dino"})[2] is None
    assert room_cli.load_room_files(room, "dino_iphone", {"dataset": "ScanNetPP"})[2] is None


# the backbone's kernel ops that take coordinates
KERNEL_OPS = ("avg_voxelize", "ball_query_group_rel", "furthest_point_sample",
              "nearest_neighbor_interpolate", "trilinear_devoxelize",
              "trilinear_devoxelize_with_mean")


def test_conditioned_forward_gives_the_kernels_contiguous_tensors(monkeypatch):
    """The kernels take contiguous tensors only (kernels.check); the
    conditioned input's coordinates are a slice of [x | x_cond], so the
    backbone must make them contiguous before the first kernel op. Every
    coordinate tensor ([..., 3]) reaching a kernel op is checked (the CPU's
    plain grids are permuted views where the card's kernels write
    contiguous ones, so only coordinates tell here)."""
    from p2p_bridge_tpu_torch.models import pvcnn

    seen = []

    def recording(name, fn):
        def call(*args, **kw):
            seen.append((name, [a.is_contiguous() for a in args
                                if torch.is_tensor(a) and a.shape[-1] == 3]))
            return fn(*args, **kw)
        return call

    for name in KERNEL_OPS:
        monkeypatch.setattr(pvcnn, name, recording(name, getattr(pvcnn, name)))
    model = build_unet_from_config(room_config()).eval()
    x, _, feats = synthetic_room(14, 2 * PATCH)
    with torch.no_grad():
        model(torch.from_numpy(x[None, :PATCH]), torch.tensor([500.0]),
              torch.from_numpy(feats[None, :PATCH]))
    assert {name for name, _ in seen} == set(KERNEL_OPS) - {"trilinear_devoxelize"}
    assert [(name, flags) for name, flags in seen if not all(flags)] == []
