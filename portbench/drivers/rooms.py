"""Room traffic: synthetic ScanNet++-like scans through the program's
``rooms.denoise_room``, one room after another (a closed loop).

Traffic parameters (``traffic/<mix>.json``): ``distinct`` room layouts,
made from ``layout_seed`` (the same rooms, so the same work, for every
seed) and cycled; ``points``, ``sigma`` (metres) and ``outliers`` (a
share) of each scan, sampled from the run's seed; ``features`` (the DINO
channels, standard normal from the seed, laid out as ``denoise_room.py``
reads them: [C, N] transposed);
``k``, ``batch_size``, ``radius``, ``steps``, ``room_seed``: the call's
arguments (the CLI's defaults; patch size the configuration's
``data.npoints``); ``traced_rooms``; ``checked_patches``: the points of that
many patches, drawn from the seed, are held to the reference with every
patch that holds them.

End-to-end: ``room_points_per_s``, the points of the rooms completed in
the window over its time. The window also counts the real patches of its
rooms (not the last batch's padding), for ``mfu.room``.

The check follows the program where a choice is discrete, and holds each
such choice to the reference by itself: the host FPS picks (seeding and
neighbourhood splits) by the FPS certificate (``fps_cover_excess``), the
neighbourhoods and the patches built from them exactly
(``patch_mismatch``), the set-abstraction picks of the checked patches
exactly (``fps_mismatch``); then the reference denoises the checked
patches in float32 following those picks, averages them as the room does,
and ``drift_mean`` is the mean distance between the program's and the
reference's prediction of the checked points.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch

from .. import compare, generators
from ..flops import forward_flops
from ..reference import bridge as ref_bridge
from ..reference import ops as ref_ops
from ..reference import rooms as ref_rooms
from ..reference.model import Mismatch
from ..tracing import Tracer, recorder
from ..weights import make_state_dict
from .objects import program_bridge, reference_model


PATCHES = "rooms.create_patches"


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.attempted = self.failed = 0
        self.patch = int(cfg["data"]["npoints"])
        self.state = make_state_dict(cfg, seed, self.device)
        self.bridge = program_bridge(cfg, self.state, self.device)
        rng, layouts = np.random.default_rng(seed), np.random.default_rng(traffic["layout_seed"])
        t = traffic
        self.rooms = []
        for _ in range(t["distinct"]):
            mesh = generators.room_mesh(layouts)
            pts = generators.noisy_room(mesh, t["points"], t["sigma"], t["outliers"], rng)
            feats = rng.standard_normal((t["features"], t["points"]), dtype=np.float32).T
            self.rooms.append((pts, feats))
        self.outputs, self.checked, self.recorder = {}, None, None
        self.done_flops, self.elapsed = 0, 0.0  # of the window's completed rooms

    # -- the program ------------------------------------------------------
    def call(self, i: int) -> np.ndarray:
        from p2p_bridge_tpu_torch import rooms

        t = self.traffic
        pts, feats = self.rooms[i % len(self.rooms)]
        spans = recorder(("rooms.bucket_fps", PATCHES,
                          "models.pvcnn.furthest_point_sample")) if i == self.checked else None
        with spans.wrapped() if spans else nullcontext():
            out = rooms.denoise_room(self.bridge, pts, steps=t["steps"], k=t["k"],
                                     patch_size=self.patch, batch_size=t["batch_size"],
                                     query_radius=t["radius"], room_features=feats,
                                     use_feat=True, average_predictions=True,
                                     seed=t["room_seed"])["denoised"]
        if spans:
            self.recorder = spans
        return out

    def rooms_run(self, count: int = None, seconds: float = None) -> tuple:
        """Rooms 0, 1, ... until ``count`` are done or ``seconds`` have passed
        at a room's end -> (rooms done, seconds, their real patches)."""
        done = 0
        counter = Tracer(ranges=False)
        counter.span(PATCHES, lambda out, *args, **kwargs: len(out[0]))
        with counter.wrapped():
            t0 = time.perf_counter()
            while True:
                self.outputs[done] = self.call(done)
                done += 1
                elapsed = time.perf_counter() - t0
                if done == count or (seconds is not None and elapsed >= seconds):
                    return done, elapsed, sum(counter.recorded(PATCHES))

    def warm(self) -> None:
        """One room: every batch of a room has the one padded shape."""
        self.checked = -1
        self.call(-1)
        self.outputs.clear()

    def window(self, seconds: float) -> dict:
        self.checked = int(np.random.default_rng((self.seed, 1)).integers(len(self.rooms)))
        done, elapsed, patches = self.rooms_run(seconds=seconds)
        self.attempted = done
        self.done_flops = patches * self.traffic["steps"] * forward_flops(self.cfg, 1)
        self.elapsed = elapsed
        if self.checked >= done:
            self.checked = None
        return {"room_points_per_s": self.traffic["points"] * done / elapsed}

    def trace(self, tracer) -> None:
        count = self.traffic["traced_rooms"]
        self.checked = 0
        tracer.run(lambda: self.rooms_run(count=count)[0])

    def release(self) -> None:
        self.bridge = None

    # -- the reference ----------------------------------------------------
    def check(self) -> list:
        if self.checked is None or self.recorder is None:
            return [(name, float("inf")) for name in
                    ("drift_mean", "fps_cover_excess", "patch_mismatch", "fps_mismatch")]
        with torch.no_grad():
            plan, excess, mismatch = self.patching()
            checked = self.checked_patches(plan)
            model = reference_model(self.cfg, self.state, self.device)
            picks, fps_bad = self.program_picks(checked)
            try:
                ref = self.reference_points(model, plan, checked, picks)
            except Mismatch:
                return [("drift_mean", float("inf")), ("fps_cover_excess", excess),
                        ("patch_mismatch", mismatch), ("fps_mismatch", fps_bad)]
            served = torch.from_numpy(self.outputs[self.checked]).to(self.device)
            rows = torch.from_numpy(ref[0]).to(self.device)
            drift = float((served[rows] - ref[1]).norm(dim=1).mean())
        return [("drift_mean", drift), ("fps_cover_excess", excess),
                ("patch_mismatch", mismatch), ("fps_mismatch", fps_bad)]

    def patching(self) -> tuple:
        """(the patches as the reference builds them from the program's FPS
        picks, the largest FPS certificate excess, patches that differ)."""
        t = self.traffic
        pts = self.rooms[self.checked % len(self.rooms)][0]
        n_seeds = int(np.ceil(len(pts) / self.patch) * t["k"])
        fps_calls = self.recorder.recorded("rooms.bucket_fps")
        (args, kwargs), seed_idx = fps_calls[0]
        excess = -float("inf")
        for (a, _), idx in fps_calls:
            cand = torch.from_numpy(np.asarray(a[0], np.float32)).to(self.device)
            pool = cand[torch.from_numpy(ref_rooms.fps_pool(len(cand), a[1])).to(self.device)]
            picks = cand[torch.from_numpy(np.asarray(idx)).to(self.device)]
            excess = max(excess, compare.cover_excess(picks, pool))
        room = torch.from_numpy(pts).to(self.device)
        hoods = ref_rooms.radius_neighbourhoods(room, room[torch.from_numpy(
            np.asarray(seed_idx)).to(self.device)], t["radius"])
        splits = [np.asarray(idx) for _, idx in fps_calls[1:]]
        plan = ref_rooms.patch_plan(pts, self.patch, hoods, splits,
                                    np.random.default_rng(t["room_seed"]))
        (_, _), (xyz, _, _, idxs, cuts) = self.recorder.recorded(PATCHES)[0]
        mismatch = abs(len(plan) - len(xyz))
        for p, (r_xyz, r_idx, r_cut) in enumerate(plan[:len(xyz)]):
            if not (np.array_equal(r_xyz, xyz[p]) and np.array_equal(r_idx, idxs[p])
                    and r_cut == cuts[p]):
                mismatch += 1
        if len(seed_idx) != n_seeds:
            mismatch += 1
        return plan, excess, mismatch

    def checked_patches(self, plan) -> list:
        """The patches holding the points of ``checked_patches`` patches drawn
        from the seed."""
        rng = np.random.default_rng((self.seed, 2))
        first = rng.choice(len(plan), self.traffic["checked_patches"], replace=False)
        rows = np.unique(np.concatenate([plan[p][1][:plan[p][2]] for p in first]))
        holds = [p for p, (_, idx, cut) in enumerate(plan) if np.isin(idx[:cut], rows).any()]
        self.checked_rows = rows
        return holds

    def program_picks(self, patches: list) -> tuple:
        """(the set-abstraction picks of the given patches, stacked per
        forward as the reference's batch takes them; the picks of their
        batches that differ from the reference's FPS of the same
        coordinates)."""
        bs = self.traffic["batch_size"]
        calls = self.recorder.recorded("models.pvcnn.furthest_point_sample")
        per_batch = len(calls) // -(-len(self.recorder.recorded(PATCHES)[0][1][0])
                                    // bs)
        picks, bad = [], 0
        for j in range(per_batch):
            rows = [calls[(p // bs) * per_batch + j][1][p % bs] for p in patches]
            picks.append(torch.stack(rows))
        for b in sorted({p // bs for p in patches}):
            for (a, _), idx in calls[b * per_batch:(b + 1) * per_batch]:
                bad += int((ref_ops.fps(a[0], a[1]) != idx.long()).sum())
        return picks, bad

    def reference_points(self, model, plan, patches, picks) -> tuple:
        """(the checked room points, the reference's averaged prediction of
        each) from the given patches."""
        t = self.traffic
        feats = self.rooms[self.checked % len(self.rooms)][1]
        xyz = torch.from_numpy(np.stack([plan[p][0] for p in patches])).to(self.device)
        cond = torch.from_numpy(np.stack([feats[plan[p][1]] for p in patches])).to(self.device)
        rel, center, scale = ref_rooms.normalise(xyz)
        model.prec.picks = None if picks is None else list(picks)
        pred = ref_bridge.sample(model, ref_bridge.Schedule(self.cfg), rel, t["steps"], cond)
        model.prec.picks = None
        pred = pred * scale + center
        sums, counts = ref_rooms.recompose(len(self.rooms[0][0]), pred,
                                           [plan[p][1] for p in patches],
                                           np.asarray([plan[p][2] for p in patches]))
        rows = torch.from_numpy(self.checked_rows).to(self.device)
        return self.checked_rows, (sums[rows] / counts[rows, None]).float()

    def control(self, precision: str = "fp8") -> list:
        """The reference computed in ``precision`` put in the program's place
        for the checked patches (its own set-abstraction picks), averaged,
        against the float32 reference following those picks."""
        with torch.no_grad():
            plan = self.patching()[0]
            checked = self.checked_patches(plan)
            stand_in = reference_model(self.cfg, self.state, self.device, precision)
            stand_in.prec.recorded = picks = []
            got = self.reference_points(stand_in, plan, checked, None)[1]
            model = reference_model(self.cfg, self.state, self.device)
            want = self.reference_points(model, plan, checked, picks)[1]
            return [("drift_mean", float((got - want).norm(dim=1).mean()))]

    @classmethod
    def calibrate(cls, cfg, traffic, seed, device, calls, control, witness) -> dict:
        d = cls(cfg, traffic, seed, device)
        d.warm()
        d.checked = 0
        d.outputs[0] = d.call(0)
        d.release()
        row = {"program": dict(d.check())}
        for key, precision in (("control", control), ("witness", witness)):
            if precision:
                row[key] = dict(d.control(precision), precision=precision)
        return row

