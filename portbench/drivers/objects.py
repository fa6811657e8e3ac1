"""Object denoising traffic: clouds through the program's
``inference.patch_based_denoise_batch``.

Traffic parameters (``traffic/<mix>.json``):

* ``sizes``, ``shapes``, ``sigmas``: cloud m of the ``distinct`` clouds
  made from the seed has ``sizes[m % len]`` points, shape
  ``shapes[m % len]`` and noise ``sigmas[m % len]`` (a share of the unit
  sphere); call i sends clouds (i * clouds_per_call + k) % distinct, so
  every seed sends the same sizes in the same order;
* ``clouds_per_call``, ``recombine`` ("exact" or "bucketed"), ``seed_k``,
  ``steps``: the call's arguments (patch size: the configuration's
  ``data.npoints``);
* ``pipelined``: false, a closed loop of one client that waits for each
  denoised cloud on the host; true, calls dispatched back to back with
  ``as_numpy=False``, each pulled to the host after the next is issued;
* ``traced_calls``: calls in the traced window (after an untraced window,
  whose model FLOPs and time ``mfu.denoise`` reads);
* ``checked_calls``: calls held to the reference after the window, drawn
  from the seed before it among the first ``checked_among`` (which every
  window completes), one of each size among them.

End-to-end: ``denoise_points_per_s`` (points of the calls completed in the
window over its time) and, closed loop, ``denoise_ms_p90`` (the 90th
percentile of the calls' host latency, call to denoised cloud on the host).

The check. A checked call records, from outside, the states its sampler
went through (``P2PBridge.sample``'s chain) and every furthest point
sampling it ran. The backbone chooses by thresholds on the coordinates
(FPS, ball query, voxel cells, 3-NN), so a rounding that moves a point
across one sends a f32 run elsewhere than a bf16 run however right both
are; the reference therefore follows the program step by step: it builds
the start itself (seeding, kNN patches, joint normalisation) and holds the
program's to it (``start_gap``, the largest coordinate gap), then takes
each sampling step in float32 from the program's previous state
(``step_drift``, the mean distance over steps and patch points, in units
of the unit sphere), and holds the served points to its last step's
points at the places the recombination picked (``served_drift``, the
mean). The recombination's picks, and every other FPS of the call, are
held to the reference's FPS of the same coordinates (``fps_mismatch``,
the indices that differ).
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch

from .. import generators
from ..flops import forward_flops
from ..reference import bridge as ref_bridge
from ..reference import ops as ref_ops
from ..reference.model import Unet
from ..tracing import recorder
from ..weights import make_state_dict

# the program's furthest point samplings: the set-abstraction stages, then
# the seeding and the recombination
FPS_TARGETS = ("models.pvcnn.furthest_point_sample", "inference.furthest_point_sample")
SAMPLE = "models.p2pb.P2PBridge.sample"  # its x_chain: every step's state


def program_bridge(cfg: dict, state: dict, device):
    """The program's P2PBridge on ``device`` with the given weights."""
    from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
    from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config

    with torch.device("meta"):
        model = build_unet_from_config(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return P2PBridge.from_config(cfg, model.eval())


def reference_model(cfg: dict, state: dict, device, precision: str = "f32") -> Unet:
    with torch.device("meta"):
        model = Unet(cfg, precision)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.eval()


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.attempted = self.failed = 0
        self.patch = int(cfg["data"]["npoints"])
        self.state = make_state_dict(cfg, seed, self.device)
        self.bridge = program_bridge(cfg, self.state, self.device)
        rng = np.random.default_rng(seed)
        t = traffic
        self.clouds = [generators.noisy_object(t["shapes"][m % len(t["shapes"])],
                                               t["sizes"][m % len(t["sizes"])],
                                               t["sigmas"][m % len(t["sigmas"])], rng)
                       for m in range(t["distinct"])]
        self.outputs = {}  # call index -> denoised clouds [O, N, 3] on the host
        self.checked, self.recorders = [], {}
        self.flops = {}  # (clouds, points) -> model FLOPs of a call
        self.done_flops, self.elapsed = 0, 0.0  # of the window's completed calls

    def choose_checked(self, among: int) -> None:
        """Draw from the seed the calls to check among the first ``among``:
        one of each size, the largest first, then others, up to
        ``checked_calls``."""
        rng = np.random.default_rng((self.seed, 1))
        calls = list(range(among))
        picked = []
        for n in sorted({self.call_clouds(i).shape[1] for i in calls}, reverse=True):
            pool = [i for i in calls if self.call_clouds(i).shape[1] == n]
            picked.append(int(rng.choice(pool)))
        rest = [i for i in calls if i not in picked]
        extra = min(self.traffic["checked_calls"] - len(picked), len(rest))
        if extra > 0:
            picked += [int(i) for i in rng.choice(rest, extra, replace=False)]
        self.checked = picked[:self.traffic["checked_calls"]]
        self.recorders = {}

    # -- the program ------------------------------------------------------
    def call_clouds(self, i: int) -> np.ndarray:
        c, d = self.traffic["clouds_per_call"], self.traffic["distinct"]
        return np.stack([self.clouds[(i * c + k) % d] for k in range(c)])

    def call(self, i: int, as_numpy: bool = True):
        """Call i; a checked call records its sampler's states and its
        furthest point samplings."""
        from p2p_bridge_tpu_torch.inference import patch_based_denoise_batch

        t = self.traffic
        spans = None
        if i in self.checked:
            spans = self.recorders[i] = recorder(FPS_TARGETS + (SAMPLE,))
        with spans.wrapped() if spans else nullcontext():
            return patch_based_denoise_batch(
                self.bridge, self.call_clouds(i), patch_size=self.patch, seed_k=t["seed_k"],
                steps=t["steps"], recombine_mode=t["recombine"], device=self.device,
                as_numpy=as_numpy)[0]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def calls(self, first: int, count: int = None, seconds: float = None) -> tuple:
        """Calls first, first + 1, ... until ``count`` are done or ``seconds``
        have passed at a call's end -> (calls done, seconds, host latency of
        each call; pipelined calls have none)."""
        done, lat = 0, []
        t0 = time.perf_counter()
        if not self.traffic["pipelined"]:
            while True:
                ts = time.perf_counter()
                self.outputs[first + done] = self.call(first + done)
                te = time.perf_counter()
                lat.append(te - ts)
                done += 1
                if done == count or (seconds is not None and te - t0 >= seconds):
                    return done, te - t0, lat
        pending = None
        while True:
            out = self.call(first + done, as_numpy=False)
            if pending is not None:
                self.outputs[pending[0]] = pending[1].cpu().numpy()
            pending = (first + done, out)
            done += 1
            if done == count or (seconds is not None and time.perf_counter() - t0 >= seconds):
                break
        self.outputs[pending[0]] = pending[1].cpu().numpy()
        return done, time.perf_counter() - t0, lat

    def warm(self) -> None:
        """Two calls of each size the window sends (pipelined: back to back)."""
        per = len(self.traffic["sizes"]) if self.traffic["clouds_per_call"] == 1 else 1
        self.calls(-2 * per, count=2 * per)
        self.sync()
        self.outputs.clear()

    def points(self, i: int) -> int:
        return int(np.prod(self.call_clouds(i).shape[:2]))

    def call_flops(self, i: int) -> int:
        """Model FLOPs of call i: every sampling step's forward over the
        patches of each cloud."""
        o, n = self.call_clouds(i).shape[:2]
        if (o, n) not in self.flops:
            patches = int(self.traffic["seed_k"] * n / self.patch)
            self.flops[o, n] = o * self.traffic["steps"] * forward_flops(self.cfg, patches)
        return self.flops[o, n]

    def window(self, seconds: float) -> dict:
        self.choose_checked(self.traffic["checked_among"])
        done, elapsed, lat = self.calls(0, seconds=seconds)
        self.attempted = done
        self.checked = [i for i in self.checked if i < done]
        self.done_flops = sum(self.call_flops(i) for i in range(done))
        self.elapsed = elapsed
        out = {"denoise_points_per_s": sum(self.points(i) for i in range(done)) / elapsed}
        if lat:
            out["denoise_ms_p90"] = float(np.percentile(np.asarray(lat) * 1e3, 90))
        return out

    def trace(self, tracer) -> None:
        count = self.traffic["traced_calls"]
        self.choose_checked(count)
        tracer.run(lambda: self.calls(0, count=count)[0])

    def release(self) -> None:
        """Free the program's state (the weights made from the seed stay)."""
        self.bridge = None

    # -- the reference ----------------------------------------------------
    def reference_start(self, cloud: np.ndarray) -> tuple:
        """The reference's patches of one cloud [N, 3]: (patches in their
        joint frame [S, K, 3], centres [S, 1, 3], scale)."""
        x = torch.from_numpy(cloud).to(self.device)[None]
        n = x.shape[1]
        seeds = ref_ops.take(x, ref_ops.fps(x, int(self.traffic["seed_k"] * n / self.patch)))
        patches = x[0][ref_ops.knn(seeds, x, self.patch)[0]]
        centers = patches.mean(dim=1, keepdim=True)
        patches = patches - centers
        scale = torch.linalg.norm(patches, dim=-1).max()
        return patches / scale, centers, scale

    def program_states(self, i: int, k: int):
        """The states the program's sampler went through for cloud k of call
        i, start first ([S, K, 3] each), or None where its recorded call
        holds no such chain."""
        calls = self.recorders[i].recorded(SAMPLE)
        if len(calls) <= k:
            return None
        (args, _), out = calls[k]
        chain = out.get("x_chain") if isinstance(out, dict) else None
        steps = self.traffic["steps"]
        if chain is None or chain.dim() != 4 or chain.shape[1] != steps:
            return None
        return [args[1]] + [chain[:, j] for j in reversed(range(steps))]

    def program_recombined(self, i: int, k: int) -> torch.Tensor:
        """Cloud k's picks of call i's recombination (the last FPS the call
        ran in ``inference``)."""
        idx = self.recorders[i].recorded(FPS_TARGETS[1])[-1][1]
        if self.traffic["recombine"] == "exact":
            return idx[k]
        S = idx.shape[0] // self.traffic["clouds_per_call"]
        return idx[k * S:(k + 1) * S]

    def counterparts(self, ref: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
        """The reference's points [n, 3] at the served points' places: the
        recombination's picks ``idx`` of one cloud (exact: [n] into the S * K
        patch points; bucketed: [S, per] into each patch, served at rank *
        S + patch) taken from the reference's patches [S, K, 3]."""
        if self.traffic["recombine"] == "exact":
            return ref.reshape(-1, 3)[idx.long()]
        picked = ref_ops.take(ref, idx)  # [S, per, 3]
        return picked.transpose(0, 1).reshape(-1, 3)[:n]

    def recombine(self, patches: torch.Tensor, n: int) -> tuple:
        """The reference's recombination of denoised patches [S, K, 3] to n
        points, one FPS over all of them (exact) or ceil(n / S) of each
        patch with the surplus cut from the last-ranked picks (bucketed) ->
        (points [n, 3], picks as ``counterparts`` takes them)."""
        S = patches.shape[0]
        if self.traffic["recombine"] == "exact":
            idx = ref_ops.fps(patches.reshape(1, -1, 3), n)[0]
        else:
            idx = ref_ops.fps(patches, -(-n // S))
        return self.counterparts(patches, idx, n), idx

    def held(self, served, states, recombined) -> list:
        """The numbers of the checked calls' clouds: ``served(i, k)`` the
        k-th cloud of call i as served, ``states(i, k)`` the sampler's states
        that produced it (start first), ``recombined(i, k)`` the
        recombination's picks. The float32 reference builds the start itself
        and takes each step from the served side's previous state."""
        if not self.checked:
            return [(name, float("inf")) for name in ("start_gap", "step_drift", "served_drift")]
        model = reference_model(self.cfg, self.state, self.device)
        plan = ref_bridge.Schedule(self.cfg).plan(self.traffic["steps"])
        start, step_d, served_d = 0.0, [], []
        for i in self.checked:
            for k, cloud in enumerate(self.call_clouds(i)):
                x1, centers, scale = self.reference_start(cloud)
                st = states(i, k)
                if st is None or st[0].shape != x1.shape:
                    return [(name, float("inf")) for name in
                            ("start_gap", "step_drift", "served_drift")]
                start = max(start, float((st[0] - x1).abs().max()))
                for coefs, now, after in zip(plan, st, st[1:]):
                    ref_after = ref_bridge.step(model, coefs, now)
                    step_d.append(((after - ref_after).norm(dim=-1) * scale).flatten())
                final = ref_after * scale + centers
                got = torch.as_tensor(served(i, k), device=self.device)
                want = self.counterparts(final, recombined(i, k), cloud.shape[0])
                served_d.append((got - want).norm(dim=-1))
        return [("start_gap", start), ("step_drift", float(torch.cat(step_d).mean())),
                ("served_drift", float(torch.cat(served_d).mean()))]

    def fps_mismatch(self) -> int:
        """Indices of the program's furthest point samplings in the checked
        calls (seeding, set abstraction, recombination) that differ from the
        reference's FPS of the same coordinates."""
        bad = 0
        for i in self.checked:
            for target in FPS_TARGETS:
                for (args, _), idx in self.recorders[i].recorded(target):
                    bad += int((ref_ops.fps(args[0], idx.shape[1]) != idx.long()).sum())
        return bad

    def check(self) -> list:
        with torch.no_grad():
            return self.held(lambda i, k: self.outputs[i][k], self.program_states,
                             self.program_recombined) + [("fps_mismatch", self.fps_mismatch())]

    def control(self, precision: str = "fp8") -> list:
        """The numbers of the reference computed in ``precision`` put in the
        program's place: its own patches, trajectory and recombination."""
        with torch.no_grad():
            model = reference_model(self.cfg, self.state, self.device, precision)
            served, states, recombined = {}, {}, {}
            for i in self.checked:
                for k, cloud in enumerate(self.call_clouds(i)):
                    x1, centers, scale = self.reference_start(cloud)
                    states[i, k] = [x1]
                    final = ref_bridge.sample(model, ref_bridge.Schedule(self.cfg), x1,
                                              self.traffic["steps"], states=states[i, k])
                    served[i, k], recombined[i, k] = self.recombine(final * scale + centers,
                                                                    cloud.shape[0])
            return self.held(lambda i, k: served[i, k], lambda i, k: states[i, k],
                             lambda i, k: recombined[i, k])

    @classmethod
    def calibrate(cls, cfg, traffic, seed, device, calls, control, witness) -> dict:
        """The numbers of ``calls`` calls of the program (default: two of
        each size) and of the stand-ins, for ``portbench.calibrate``."""
        d = cls(cfg, traffic, seed, device)
        d.warm()
        among = calls or 2 * len(traffic["sizes"])
        d.choose_checked(among)
        d.calls(0, count=among)
        d.sync()
        d.release()
        row = {"checked": d.checked, "program": dict(d.check())}
        for key, precision in (("control", control), ("witness", witness)):
            if precision:
                row[key] = dict(d.control(precision), precision=precision)
        return row
