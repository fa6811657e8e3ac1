"""Patch-based object denoising of the port against the JAX package, and
the port's denoise_object CLI, on the CPU."""

import jax
import numpy as np
import pytest
import torch
import yaml
from test_torch_model import (
    GLOBAL_EMBED_TOL,
    TOL,
    bf16_tiny,
    build_pair,
    tiny,
    with_compute_dtype,
)

from p2p_bridge_tpu.data.transforms import normalize_unit_sphere
from p2p_bridge_tpu.inference import (
    _build_object_program,
    _build_recombine,
    _build_recombine_bucketed,
)
from p2p_bridge_tpu.inference import patch_based_denoise_batch as jax_denoise
from p2p_bridge_tpu.models.unet_pvc import build_unet_from_config as jax_build
from p2p_bridge_tpu.models.p2pb import P2PBridge as JaxBridge
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu.utils.io import read_xyz, write_xyz
from p2p_bridge_tpu.utils.torch_compat import convert_torch_state_dict
from p2p_bridge_tpu_torch import denoise_object
from p2p_bridge_tpu_torch.inference import (
    _denoise_one,
    patch_based_denoise_batch,
    recombine_bucketed,
    recombine_exact,
)
from p2p_bridge_tpu_torch.models.p2pb import P2PBridge
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters


def noisy_sphere(seed, n=1024):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    p += 0.02 * rng.normal(size=(n, 3))
    p -= p.mean(0)
    return (p / np.linalg.norm(p, axis=1).max()).astype(np.float32)


@pytest.fixture(scope="module", params=[True, False], ids=["global_embed", "no_global_embed"])
def bridges(request):
    """Both bridges over the same TINY weights. The head is scaled by 0.01
    so the two-step chain stays smooth (see test_sample_matches_jax)."""
    cfg = tiny(request.param)
    fmodel, variables, tmodel = build_pair(cfg, head_scale=0.01)
    return (JaxBridge.from_config(Config(cfg), fmodel), variables,
            P2PBridge.from_config(cfg, tmodel),
            GLOBAL_EMBED_TOL if request.param else TOL)


@pytest.mark.parametrize("mode", ["exact", "bucketed"])
def test_patch_based_denoise_batch_matches_jax(bridges, mode):
    """Seeding, patching and sampling agree within the tolerance, and the
    recombination of the same denoised patches picks the same points.

    The two end-to-end outputs are not compared point by point: FPS is
    discontinuous, so a 1e-5 move of the denoised patches flips a near tie
    (measured at pick 983 of 1024 without the global embedding, 179 with
    it), and the later picks differ by the point spacing. Instead every
    point the port returns must be, within the tolerance, one of the
    denoised points the JAX package produced."""
    fb, variables, tb, tol = bridges
    pcls = noisy_sphere(0)[None]
    N, K, S = 1024, 256, 12
    want_flat, _ = _build_object_program(fb, N, K, S, 2, False, False)(variables, pcls)
    want_flat = np.array(want_flat)  # writable: torch.from_numpy below
    with torch.no_grad():
        got_flat, _ = _denoise_one(tb, torch.from_numpy(pcls), K, S, 2, False, False)
    err = np.abs(got_flat.numpy() - want_flat).max()
    assert err <= tol * max(1.0, np.abs(want_flat).max()), err

    if mode == "exact":
        jax_rec, port_rec = _build_recombine(N), lambda f: recombine_exact(f, N)
    else:
        jax_rec = _build_recombine_bucketed(N, S, K)
        port_rec = lambda f: recombine_bucketed(f, N, S, K)  # noqa: E731
    np.testing.assert_array_equal(port_rec(torch.from_numpy(want_flat)).numpy(),
                                  np.asarray(jax_rec(want_flat)))

    kw = dict(patch_size=K, seed_k=3, steps=2, recombine_mode=mode)
    want, _ = jax_denoise(fb, variables, pcls, **kw)
    got, _ = patch_based_denoise_batch(tb, pcls, **kw)
    assert got.shape == want.shape == (1, N, 3)
    nearest = torch.cdist(torch.from_numpy(got[0]), torch.from_numpy(want_flat[0]),
                          compute_mode="donot_use_mm_for_euclid_dist").min(1).values
    assert nearest.max().item() <= 2 * tol * max(1.0, np.abs(want_flat).max())


def test_patch_based_denoise_batch_bf16_matches_jax():
    """The bf16 backbone inside the bucketed patch denoise, against the
    JAX package's bf16 program on the same weights (head scaled by 0.01,
    as above). The denoised patches move by 0.01 of the network output
    per step, so the bf16 spread of that output (tests/test_torch_model.py
    BF16_REL_L2) is a small share of the patch coordinates: 1e-2 x
    max(1, max|out|)."""
    cfg = bf16_tiny()
    fmodel, variables, tmodel = build_pair(cfg, head_scale=0.01)
    assert tmodel.dtype == torch.bfloat16
    fb, tb = JaxBridge.from_config(Config(cfg), fmodel), P2PBridge.from_config(cfg, tmodel)
    pcls = noisy_sphere(4, 512)[None]
    N, K, S = 512, 256, 6
    want_flat, _ = _build_object_program(fb, N, K, S, 2, False, False)(variables, pcls)
    want_flat = np.array(want_flat)
    with torch.no_grad():
        got_flat, _ = _denoise_one(tb, torch.from_numpy(pcls), K, S, 2, False, False)
    err = np.abs(got_flat.numpy() - want_flat).max()
    assert err <= 1e-2 * max(1.0, np.abs(want_flat).max()), err
    got, _ = patch_based_denoise_batch(tb, pcls, patch_size=K, seed_k=3, steps=2,
                                       recombine_mode="bucketed")
    assert got.shape == (1, N, 3) and np.isfinite(got).all()


def test_intermediate_steps_shape(bridges):
    _, _, tb, _ = bridges
    pcls = np.stack([noisy_sphere(1, 512), noisy_sphere(2, 512)])
    out, chain = patch_based_denoise_batch(tb, pcls, patch_size=256, steps=2,
                                           save_intermediate=True, recombine_mode="bucketed")
    assert out.shape == (2, 512, 3) and chain.shape == (2, 2, 512, 3)
    assert np.isfinite(out).all() and np.isfinite(chain).all()
    with pytest.raises(ValueError):
        patch_based_denoise_batch(tb, pcls, patch_size=256, recombine_mode="nearest")


@pytest.mark.parametrize("mode", ["exact", "bucketed"])
def test_as_numpy_false_returns_the_same_clouds_as_a_tensor(mode):
    """as_numpy=False (the pipelined form): the denoised clouds as a
    tensor on the model's device, equal to the default call's array, and
    the chain as numpy, as the JAX package returns them (a TINY port
    model, no JAX side)."""
    cfg = tiny(True)
    model = build_unet_from_config(cfg).eval()
    init_parameters(model, torch.Generator().manual_seed(0))
    tb = P2PBridge.from_config(cfg, model)
    pcls = noisy_sphere(1, 512)[None]
    kw = dict(patch_size=256, steps=2, save_intermediate=True, recombine_mode=mode)
    want, want_chain = patch_based_denoise_batch(tb, pcls, **kw)
    got, chain = patch_based_denoise_batch(tb, pcls, as_numpy=False, **kw)
    assert isinstance(got, torch.Tensor) and got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert isinstance(chain, np.ndarray)
    np.testing.assert_array_equal(chain, want_chain)


@pytest.mark.parametrize("weights", ["npz", "pt"])
def test_denoise_object_cli_on_cpu(tmp_path, weights):
    """The CLI loads opt.yaml + weights (JAX .npz or a reference-named torch
    checkpoint) and writes what patch_based_denoise_batch gives for the
    same weights and cloud. opt.yaml sets training.amp, so the CLI
    computes in bf16; with the .npz weights an override
    --model.compute_dtype f32 turns that back to f32."""
    cfg = dict(tiny(True), training={"amp": True})
    f32 = weights == "npz"
    tmodel = build_unet_from_config(cfg).eval()
    init_parameters(tmodel, torch.Generator().manual_seed(0))
    with torch.no_grad():
        tmodel.classifier[2].weight.mul_(0.01)
    run = tmp_path / "run"
    run.mkdir()
    with open(run / "opt.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    if weights == "npz":
        fmodel = jax_build(Config(cfg))
        template = jax.eval_shape(lambda: fmodel.init(
            {"params": jax.random.key(0)}, np.zeros((1, 256, 3), np.float32),
            np.zeros((1,), np.float32), None, True))
        params = convert_torch_state_dict(tmodel.state_dict(), template)
        flat = {"/".join(p.key for p in path): np.asarray(leaf) for path, leaf in
                jax.tree_util.tree_flatten_with_path(params["params"])[0]}
        model_path = run / "params.npz"
        np.savez(model_path, **flat)
    else:
        model_path = run / "model.pt"
        torch.save({"model": tmodel.state_dict()}, model_path)
    cloud = noisy_sphere(3, 600) * 2.0 + 1.0
    data = tmp_path / "cloud.xyz"
    write_xyz(str(data), cloud)
    out = denoise_object.main([
        "--data_path", str(data), "--model_path", str(model_path), "--device", "cpu",
        "--steps", "2", "--recombine", "bucketed", "--data.npoints", "256",
        *(["--model.compute_dtype", "f32"] if f32 else [])])
    pts = read_xyz(out)
    assert pts.shape == (600, 3) and np.isfinite(pts).all()

    normed, center, scale = normalize_unit_sphere(read_xyz(str(data)))
    expected = {}
    for name in ("bf16", "f32"):
        model = build_unet_from_config(with_compute_dtype(cfg, name)).eval()
        model.load_state_dict(tmodel.state_dict())
        denoised, _ = patch_based_denoise_batch(
            P2PBridge.from_config(cfg, model), normed[None], patch_size=256, steps=2,
            recombine_mode="bucketed")
        expected[name] = denoised[0] * scale + center
    want, other = ((expected["f32"], expected["bf16"]) if f32
                   else (expected["bf16"], expected["f32"]))
    # the .xyz files keep 6 decimals
    np.testing.assert_allclose(pts, want, atol=2e-6)
    assert np.abs(pts - other).max() > 1e-5


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """The run directory that the port's training CLI writes (opt.yaml and
    model.pt): one step of PVDS_PUNet at TINY widths on the CPU."""
    from test_torch_train import ROOT, TINY_OVERRIDES, synthetic_tree

    from p2p_bridge_tpu_torch import train

    root = tmp_path_factory.mktemp("train")
    synthetic_tree(root / "data")
    train.main(["--config", str(ROOT / "configs" / "PVDS_PUNet.yaml"), "--save_dir",
                str(root / "runs"), "--device", "cpu", "--data.data_dir", str(root / "data"),
                "--training.steps", "1", *TINY_OVERRIDES])
    return root / "runs" / "PVDS_PUNet"


@pytest.mark.parametrize("form", ["run_dir", "model_pt"])
def test_denoise_object_cli_takes_the_run_directory(trained_run, tmp_path, form):
    """--model_path names the run directory that train wrote (opt.yaml and
    model.pt inside it) or its model.pt; either way the CLI denoises with
    the run's configuration and weights, as patch_based_denoise_batch does
    with them."""
    model_path = trained_run if form == "run_dir" else trained_run / "model.pt"
    data = tmp_path / "cloud.xyz"
    write_xyz(str(data), noisy_sphere(4, 500))
    out = denoise_object.main(["--data_path", str(data), "--model_path", str(model_path),
                               "--device", "cpu", "--steps", "1", "--recombine", "bucketed"])
    pts = read_xyz(out)
    assert pts.shape == (500, 3) and np.isfinite(pts).all()

    with open(trained_run / "opt.yaml") as f:
        cfg = yaml.safe_load(f)
    model = build_unet_from_config(cfg).eval()
    denoise_object.load_weights(model, str(trained_run / "model.pt"), use_ema=False)
    normed, center, scale = normalize_unit_sphere(read_xyz(str(data)))
    denoised, _ = patch_based_denoise_batch(
        P2PBridge.from_config(cfg, model), normed[None], patch_size=cfg["data"]["npoints"],
        steps=1, recombine_mode="bucketed")
    # the .xyz files keep 6 decimals
    np.testing.assert_allclose(pts, denoised[0] * scale + center, atol=2e-6)


def test_denoise_object_cli_requires_cuda_when_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        denoise_object.main(["--data_path", "x.xyz", "--model_path", str(tmp_path / "m.pt")])
