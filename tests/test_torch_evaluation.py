"""The port's evaluation against the JAX package's on the CPU: the
in-training ``get_metrics`` and ``evaluate``, the object ``Evaluator`` and
the ``evaluate_objects`` CLI.

Tolerances. Chamfer distances and the point <-> mesh distance agree to
1e-5 relative (tests/test_torch_room_metrics.py). The approximate EMD is
held to EMD_REL (tests/test_torch_emd_approx.py: the function itself
moves that much when one cloud moves by an ulp). The auction EMD compares
clouds in which each point's nearest partner is its own (noise 0.003
against a spacing near 0.08), so both frameworks find the same
assignment, and the values differ by the rounding of the expanded-form
distances: 1e-7 against squared distances near 3e-5, 1e-2 relative at
most. In ``evaluate`` both sides sample the same weights for three
deterministic steps; the samples agree to 1e-4 of their scale
(tests/test_torch_model.py), which moves a mean squared distance near
0.004 by up to 2 * 0.06 * 1e-4 * 0.5 / 0.004, about 1e-3 relative, and
the MSE likewise: both are held to 5e-3. The noisy floor is computed from
the same inputs on both sides."""

import csv
import os

import numpy as np
import pytest
import torch
import yaml
from test_torch_emd_approx import EMD_REL
from test_torch_model import build_pair, tiny

from p2p_bridge_tpu.models import evaluation as jax_eval
from p2p_bridge_tpu.models.p2pb import P2PBridge as JaxBridge
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu_torch import evaluate_objects, kernels
from p2p_bridge_tpu_torch.models import evaluation
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.utils.logging import ExperimentTracker

REL = 1e-5
SAMPLE_REL = 5e-3
EXACT_REL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The clouds here are small: torch's ops take microseconds, and CPU
    threads cost more than they give, most of all beside other test
    processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_kernel_launch():
    before = dict(kernels.launch_counts)
    yield
    assert kernels.launch_counts == before


def test_get_metrics_matches_jax():
    """N = 1000 cut to 896 (7 x 128) on both sides; [5, N] takes two
    sub-batches of the approximate EMD."""
    rng = np.random.default_rng(0)
    gt = (rng.normal(size=(5, 1000, 3)) * 0.5).astype(np.float32)
    pred = (gt + 0.02 * rng.normal(size=gt.shape)).astype(np.float32)
    got = evaluation.get_metrics(pred, gt, device="cpu")
    want = jax_eval.get_metrics(pred, gt)
    assert got.keys() == want.keys() == {"CD", "EMD", "MSE"}
    np.testing.assert_allclose(got["CD"], want["CD"], rtol=REL)
    np.testing.assert_allclose(got["EMD"], want["EMD"], rtol=EMD_REL)
    assert got["MSE"] == want["MSE"] == float(np.mean((pred[:, :896] - gt[:, :896]) ** 2))


def eval_cfg():
    cfg = tiny(False)
    cfg["data"] = {"npoints": 256, "dataset": "PUNet"}
    cfg["diffusion"]["sampling_timesteps"] = 3
    cfg["training"] = {"eval_max_batches": 4}
    return cfg


def val_batches(seed=5, batches=2, b=2, n=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        clean = (rng.normal(size=(b, n, 3)) * 0.5).astype(np.float32)
        noisy = (clean + 0.02 * rng.normal(size=clean.shape)).astype(np.float32)
        out.append({"clean_points": clean, "noisy_points": noisy})
    return out


def test_evaluate_matches_jax(tmp_path):
    """TINY weights carried by load_jax_params, a val loader of two
    batches, the deterministic sampler: every eval/* key, logged to
    metrics.jsonl, and the two renderings."""
    cfg = eval_cfg()
    fmodel, variables, tmodel = build_pair(cfg, head_scale=0.01)
    val = val_batches()
    want = jax_eval.evaluate(JaxBridge.from_config(Config(cfg), fmodel), variables, val,
                             Config(cfg), 5, out_dir=str(tmp_path / "jax"))
    tracker = ExperimentTracker(str(tmp_path / "port"), use_wandb=False)
    tmodel.train()
    got = evaluation.evaluate(P2PBridge.from_config(cfg, tmodel), val, cfg, 5,
                              out_dir=str(tmp_path / "port" / "output"), tracker=tracker)
    assert tmodel.training  # the mode is restored
    assert set(got) == set(want) == {f"eval/{p}{k}" for p in ("", "noisy_")
                                     for k in ("CD", "EMD", "MSE")}
    for key in ("eval/CD", "eval/MSE"):
        np.testing.assert_allclose(got[key], want[key], rtol=SAMPLE_REL, err_msg=key)
    for key in ("eval/EMD", "eval/noisy_EMD"):
        np.testing.assert_allclose(got[key], want[key], rtol=EMD_REL, err_msg=key)
    np.testing.assert_allclose(got["eval/noisy_CD"], want["eval/noisy_CD"], rtol=REL)
    assert got["eval/noisy_MSE"] == want["eval/noisy_MSE"]
    rec = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    assert len(rec) == 1 and "eval/noisy_EMD" in rec[0]
    assert {"0000005_pred.png", "0000005_gt.png"} <= set(os.listdir(tmp_path / "port" / "output"))


def test_evaluate_logs_before_rendering_and_restores_the_weights(tmp_path, monkeypatch):
    """A renderer that cannot import matplotlib raises after the scores
    are logged; EMA weights sample in place of the model's, which come back
    bit for bit; max_batches bounds the batches."""
    cfg = eval_cfg()
    model = build_unet_from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    own = {k: v.clone() for k, v in model.state_dict().items()}
    ema = {k: v.detach() * 0.5 for k, v in model.named_parameters()}
    bridge = P2PBridge.from_config(cfg, model)
    val = val_batches(batches=3)

    def no_matplotlib(*args, **kwargs):
        raise ImportError("visualize_pointcloud_batch needs the matplotlib package")

    monkeypatch.setattr(evaluation, "visualize_pointcloud_batch", no_matplotlib)
    tracker = ExperimentTracker(str(tmp_path), use_wandb=False)
    with pytest.raises(ImportError, match="matplotlib"):
        evaluation.evaluate(bridge, val, cfg, 1, out_dir=str(tmp_path / "out"),
                            tracker=tracker, max_batches=1, ema_params=ema)
    assert "eval/CD" in (tmp_path / "metrics.jsonl").read_text()
    assert all(torch.equal(v, own[k]) for k, v in model.state_dict().items())
    with_ema = evaluation.evaluate(bridge, val, cfg, 2, max_batches=1, ema_params=ema)
    plain = evaluation.evaluate(bridge, val, cfg, 2, max_batches=1)
    assert with_ema["eval/CD"] != plain["eval/CD"]
    assert with_ema["eval/noisy_CD"] == plain["eval/noisy_CD"]
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(ema[k])
    assert evaluation.evaluate(bridge, val, cfg, 2, max_batches=1) == with_ema


# ---------------------------------------------------------------- objects
def ellipsoid(axes, nu=12, nv=24):
    """(vertices, faces) of a UV ellipsoid."""
    th = np.linspace(1e-4, np.pi - 1e-4, nu)
    ph = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)],
                     -1).reshape(-1, 3) * axes
    faces = []
    for i in range(nu - 1):
        for j in range(nv):
            a, b = i * nv + j, i * nv + (j + 1) % nv
            c, d = a + nv, b + nv
            faces += [[a, b, c], [b, d, c]]
    return verts.astype(np.float32), np.asarray(faces, np.int64)


def surface(axes, n, rng):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True) * axes).astype(np.float32)


SHAPES = {"egg": (1.0, 0.8, 0.6), "disc": (1.0, 1.0, 0.3), "rod": (0.4, 0.4, 1.0)}


def object_tree(root, gt_points, out_points, twins, rng, noisy_dirs=()):
    """<root>/PUNet/pointclouds/test/8192_poisson/<shape>.xyz (GT),
    <root>/PUNet/meshes/test/<shape>.off, outputs in <root>/out. With
    ``twins`` each output is the GT shuffled and moved by 0.003; otherwise
    another sample of the surface moved by 0.01. ``noisy_dirs`` get the
    GT moved by 0.003 as CLI inputs."""
    gt_dir = root / "PUNet" / "pointclouds" / "test" / "8192_poisson"
    mesh_dir = root / "PUNet" / "meshes" / "test"
    out_dir = root / "out"
    for d in (gt_dir, mesh_dir, out_dir, *(root / "PUNet" / "pointclouds" / "test" / n
                                          for n in noisy_dirs)):
        d.mkdir(parents=True, exist_ok=True)
    for name, axes in SHAPES.items():
        gt = surface(axes, gt_points, rng)
        np.savetxt(gt_dir / f"{name}.xyz", gt, fmt="%.6f")
        verts, faces = ellipsoid(np.asarray(axes))
        with open(mesh_dir / f"{name}.off", "w") as f:
            f.write(f"OFF\n{len(verts)} {len(faces)} 0\n")
            f.writelines("%.6f %.6f %.6f\n" % tuple(v) for v in verts)
            f.writelines("3 %d %d %d\n" % tuple(fc) for fc in faces)
        if twins:
            out = gt[rng.permutation(gt_points)] + 0.003 * rng.normal(size=gt.shape)
        else:
            out = surface(axes, out_points, rng) + 0.01 * rng.normal(size=(out_points, 3))
        np.savetxt(out_dir / f"{name}.xyz", out.astype(np.float32), fmt="%.6f")
        for n in noisy_dirs:
            noisy = gt + 0.003 * rng.normal(size=gt.shape)
            np.savetxt(root / "PUNet" / "pointclouds" / "test" / n / f"{name}.xyz",
                       noisy.astype(np.float32), fmt="%.6f")
    return out_dir


def read_summary(path):
    import pandas as pd

    return pd.read_csv(path, index_col=0, sep=r"\s*,\s*", engine="python")


@pytest.mark.parametrize("gt_points,out_points,twins,with_emd", [
    (3000, 2500, False, False),
    # the auction at eps 0.001 and 10,000 rounds on 2048-point sub-samples
    # runs for minutes on a CPU where the matching needs many rounds (131 s
    # for JAX's, 33 s for the port's on one shape, on an 8-core host); on
    # these clouds each point's partner is clear and both end in a few rounds
    (2048, 2048, True, True),
], ids=["cd_p2m", "with_emd"])
def test_evaluator_matches_jax(tmp_path, gt_points, out_points, twins, with_emd):
    """Per shape every metric, and the same Summary_PUNet.csv as the JAX
    package's pandas reader reads it, from one process (the sub-sample
    seed hashes the shape's name)."""
    out_dir = object_tree(tmp_path, gt_points, out_points, twins, np.random.default_rng(1))
    kw = dict(output_pcl_dir=str(out_dir), dataset_root=str(tmp_path), dataset="PUNet",
              experiment_name="PUNet_test_steps5")
    got = evaluation.Evaluator(summary_dir=str(tmp_path / "port"), device="cpu", **kw).run(
        with_emd=with_emd)
    want = jax_eval.Evaluator(summary_dir=str(tmp_path / "jax"), **kw).run(with_emd=with_emd)
    assert set(got) == set(want) == set(SHAPES)
    for name, w in want.items():
        assert got[name].keys() == w.keys()
        for key, tol in (("cd_sph", REL), ("p2f", REL), ("emd_sub", EMD_REL),
                         ("emd_exact_sub", EXACT_REL)):
            if key in w:
                np.testing.assert_allclose(got[name][key], w[key], rtol=tol, err_msg=(name, key))
    port_csv = read_summary(tmp_path / "port" / "Summary_PUNet.csv")
    jax_csv = read_summary(tmp_path / "jax" / "Summary_PUNet.csv")
    assert list(port_csv.columns) == list(jax_csv.columns) == [
        f"{k}(mean)" for k in ("cd_sph", "p2f") + (("emd_sub", "emd_exact_sub") if with_emd
                                                    else ())]
    assert list(port_csv.index) == list(jax_csv.index) == ["PUNet_test_steps5"]
    np.testing.assert_allclose(port_csv.values, jax_csv.values, rtol=EXACT_REL if with_emd
                               else REL)


def write_run(run, cfg):
    """A run directory: opt.yaml and a model.pt of TINY weights whose head
    is zero, so that the sampler returns its input."""
    run.mkdir(parents=True)
    model = build_unet_from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model.classifier[-1]
        out.weight.zero_()
        out.bias.zero_()
    torch.save({"model": model.state_dict(), "ema": None}, run / "model.pt")
    with open(run / "opt.yaml", "w") as f:
        yaml.safe_dump(cfg, f)


def test_evaluate_objects_cli_on_the_cpu(tmp_path, monkeypatch):
    """python -m p2p_bridge_tpu_torch.evaluate_objects through main with
    --device cpu: one cell, its outputs in their own frame, four finite
    metrics in Summary_PUNet.csv equal to the Evaluator's on the outputs;
    a second run denoises nothing again. Without --device it asks for the
    card, and raises where there is none."""
    cfg = eval_cfg()
    cfg["training"]["amp"] = False
    object_tree(tmp_path / "data", 2048, 2048, True, np.random.default_rng(2),
                noisy_dirs=("2048_poisson_0.003",))
    write_run(tmp_path / "run", cfg)
    argv = ["--model_path", str(tmp_path / "run"), "--dataset_root", str(tmp_path / "data"),
            "--output_root", str(tmp_path / "objects"), "--resolutions", "2048_poisson",
            "--noise_levels", "0.003", "--steps", "2"]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate_objects.main(argv)
    summary = evaluate_objects.main(argv + ["--device", "cpu"])
    out_dir = tmp_path / "objects" / "PUNet_2048_poisson_0.003_steps2"
    assert summary == str(tmp_path / "objects" / "Summary_PUNet.csv")
    assert sorted(os.listdir(out_dir)) == sorted(f"{n}.xyz" for n in SHAPES)
    noisy = np.loadtxt(tmp_path / "data" / "PUNet" / "pointclouds" / "test" /
                       "2048_poisson_0.003" / "egg.xyz")
    out = np.loadtxt(out_dir / "egg.xyz")
    assert out.shape == noisy.shape and np.isfinite(out).all()
    assert np.abs(out.mean(0) - noisy.mean(0)).max() < 0.05  # back in the input's frame
    with open(summary, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["", "cd_sph(mean)", "p2f(mean)", "emd_sub(mean)", "emd_exact_sub(mean)"]
    assert rows[1][0] == "PUNet_2048_poisson_0.003_steps2"
    assert all(np.isfinite(float(v)) for v in rows[1][1:])
    mtimes = {n: os.stat(out_dir / n).st_mtime_ns for n in os.listdir(out_dir)}
    evaluate_objects.main(argv + ["--device", "cpu"])
    assert {n: os.stat(out_dir / n).st_mtime_ns for n in os.listdir(out_dir)} == mtimes
    again = evaluation.Evaluator(str(out_dir), str(tmp_path / "data"), "PUNet",
                                 str(tmp_path / "again"), rows[1][0], device="cpu").run(False)
    mean = {k: np.mean([r[k] for r in again.values()]) for k in ("cd_sph", "p2f")}
    np.testing.assert_allclose([float(rows[1][1]), float(rows[1][2])],
                               [mean["cd_sph"], mean["p2f"]], rtol=0, atol=5e-13)  # '%.12f'
