"""Each model block of the port against its flax counterpart.

Flax initialises the weights (jitted); they enter the port module through
the reference key map of p2p_bridge_tpu/utils/torch_compat.py, and the
same numpy inputs go through both. Tolerance: 1e-5 x max(1, max|out|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_bridge_tpu.models import modules as jm
from p2p_bridge_tpu.models import pvcnn as jp
from p2p_bridge_tpu.utils.torch_compat import _norm_key, _pvconv_key, _shared_mlp_key
from p2p_bridge_tpu_torch.models import modules as tm
from p2p_bridge_tpu_torch.models import pvcnn as tp
from p2p_bridge_tpu_torch.weights import _to_torch_layout, flatten_params

TOL = 1e-5
COND = 24


def init(module, *args, **kwargs):
    """jitted flax init -> numpy params."""
    fn = jax.jit(lambda k: module.init(k, *args, **kwargs))
    return jax.tree.map(np.asarray, fn(jax.random.key(0)))["params"]


def apply(module, params, *args, **kwargs):
    fn = jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kwargs))
    return jax.tree.map(np.asarray, fn(params, *args))


def load(module, params, keyfn):
    """Set ``module``'s parameters from flax ``params``; keyfn maps a flax
    path (without the leaf) to the torch prefix."""
    leaf_names = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    sd = {}
    for path, leaf in flatten_params(params).items():
        key = f"{keyfn(path[:-1])}.{leaf_names[path[-1]]}".lstrip(".")
        sd[key] = torch.tensor(_to_torch_layout(leaf, path[-1]))
    module.load_state_dict(sd, strict=True)
    return module.eval()


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def arr(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def test_time_embedding_matches_jax():
    """At t = 999 the sin/cos argument is ~999, where one f32 ulp is 6e-5,
    and exp, sin and cos are each framework's own: measured 4.4e-5."""
    t = np.array([0.0, 3.5, 999.0], np.float32)
    for dim in (16, 17, 64):
        close(tm.timestep_embedding(torch.from_numpy(t), dim),
              jm.timestep_embedding(jnp.asarray(t), dim), tol=1e-4)
    fm = jm.TimeEmbedMLP(16)
    params = init(fm, t)
    port = load(tm.time_embed_mlp(16), params, lambda p: {"Dense_0": "0", "Dense_1": "2"}[p[0]])
    with torch.no_grad():
        got = port(tm.timestep_embedding(torch.from_numpy(t), 16))
    close(got, apply(fm, params, t), tol=1e-4)


@pytest.mark.parametrize("shape", [(2, 40, 16), (2, 4, 4, 4, 16)])
def test_adagn_and_its_affine_fold_match_jax(shape):
    x, cond = arr(*shape, scale=3.0), arr(shape[0], COND, seed=1)
    fm = jm.AdaGN(num_channels=16)
    params = init(fm, x, cond)
    port = load(tm.AdaGN(16, COND), params, lambda p: _norm_key("", p)[1:])
    with torch.no_grad():
        close(port(torch.from_numpy(x), torch.from_numpy(cond)), apply(fm, params, x, cond))
        ga, be = port.affine(torch.from_numpy(cond))
    want_ga, want_be = apply(fm, params, x, cond, return_affine=True)
    close(ga, want_ga)
    close(be, want_be)


def test_se_gate_matches_jax():
    pooled = arr(3, 32)
    fm = jm.SE(channels=32, return_gate=True)
    params = init(fm, pooled=pooled)
    port = load(tm.SE(32), params, lambda p: f"fc.{2 * int(p[0].split('_')[1])}")
    with torch.no_grad():
        close(port(torch.from_numpy(pooled)), apply(fm, params, pooled=pooled))


def test_linear_attention_matches_jax():
    x = arr(2, 50, 32)
    fm = jm.LinearAttention(dim=32, heads=2)
    params = init(fm, x)
    port = load(tm.LinearAttention(32, heads=2), params, lambda p: p[0])
    with torch.no_grad():
        close(port(torch.from_numpy(x)), apply(fm, params, x))


@pytest.mark.parametrize("use_cond", [False, True])
def test_shared_mlp_matches_jax(use_cond):
    x, cond = arr(2, 16, 8, 11), arr(2, COND, seed=1)
    fm = jm.SharedMLP(out_channels=(16, 24), use_cond=use_cond)
    params = init(fm, x, cond)
    port = load(tm.SharedMLP(11, (16, 24), COND if use_cond else 0), params,
                lambda p: _shared_mlp_key("layers", p))
    with torch.no_grad():
        close(port(torch.from_numpy(x), torch.from_numpy(cond)), apply(fm, params, x, cond))


@pytest.mark.parametrize("channels", [(40, 64), (8,), (32, 70)])
def test_my_group_norm_mlp_matches_jax(channels):
    """MyGroupNorm normalises only the first C - C % 32 channels: all (64),
    none (8), or part (40, 70) of them."""
    x = arr(2, 30, 5, scale=2.0)
    fm = jm.MyGroupNormMLP(channels=channels)
    params = init(fm, x)

    def key(p):
        k = int(p[0].split("_")[1])
        return f"shared_mlp_{k}.mlp." + ("0" if p[0].startswith("Dense") else "1.group_norm")

    port = load(tm.MyGroupNormMLP(5, channels), params, key)
    with torch.no_grad():
        close(port(torch.from_numpy(x)), apply(fm, params, x))


def test_pnet2stage_matches_jax():
    """At PVDS_PUNet's widths (global_embedding_dim 1024), inputs on the
    unit sphere. (At the TINY widths the fast GroupNorm variance cancels:
    see GLOBAL_EMBED_TOL in tests/test_torch_model.py.)"""
    x = arr(2, 256, 3)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    fm = jm.Pnet2Stage(mlp1=(64, 128), mlp2=(256, 512))
    params = init(fm, x)

    def key(p):
        m = int(p[0].split("_")[1]) + 1
        k = int(p[1].split("_")[1])
        tail = "0" if p[1].startswith("Dense") else "1.group_norm"
        return f"mlp{m}.shared_mlp_{k}.mlp.{tail}"

    port = load(tm.Pnet2Stage(3, (64, 128), (256, 512)), params, key)
    with torch.no_grad():
        close(port(torch.from_numpy(x)), apply(fm, params, x))


@pytest.mark.parametrize("attention,use_se", [(False, True), (True, True), (False, False)])
def test_pvconv_matches_jax(attention, use_se):
    spec = jp.PVConvSpec(in_channels=11, out_channels=16, resolution=8, attention=attention)
    feats, coords, cond = arr(2, 200, 11), arr(2, 200, 3, seed=1, scale=0.5), arr(2, COND, seed=2)
    fm = jp.PVConv(spec=spec, use_cond=True, use_se=use_se, attn_heads=2)
    params = init(fm, feats, coords, cond)
    port = load(tp.PVConv(spec, cond_dim=COND, use_se=use_se, attn_heads=2), params,
                lambda p: _pvconv_key("", p)[1:])
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (feats, coords, cond)))
    close(got, apply(fm, params, feats, coords, cond))


def test_pvconv_plain_group_norm_matches_jax():
    spec = jp.PVConvSpec(in_channels=8, out_channels=16, resolution=4, attention=False)
    feats, coords = arr(2, 100, 8), arr(2, 100, 3, seed=1)
    fm = jp.PVConv(spec=spec, use_cond=False)
    params = init(fm, feats, coords)
    port = load(tp.PVConv(spec, cond_dim=0), params, lambda p: _pvconv_key("", p)[1:])
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(coords))
    close(got, apply(fm, params, feats, coords))


def test_sa_and_fp_modules_match_jax():
    feats, coords, cond = arr(2, 256, 8), arr(2, 256, 3, seed=1, scale=0.4), arr(2, COND, seed=2)
    sa_spec = jp.SASpec(num_centers=64, radius=0.2, num_neighbors=16, in_channels=8,
                        mlp_channels=(16, 16))
    fm = jp.PointNetSAModule(spec=sa_spec, use_cond=True)
    params = init(fm, feats, coords, cond)
    port = load(tp.PointNetSAModule(sa_spec, COND), params,
                lambda p: _shared_mlp_key("mlps.0.layers", p[1:]))
    want_f, want_c = apply(fm, params, feats, coords, cond)
    with torch.no_grad():
        got_f, got_c = port(*(torch.from_numpy(a) for a in (feats, coords, cond)))
    close(got_c, want_c)
    close(got_f, want_f)

    fp_spec = jp.FPSpec(in_channels=16 + 8, mlp_channels=(16, 8))
    fm = jp.PointNetFPModule(spec=fp_spec, use_cond=True)
    lower = np.asarray(want_f)
    args = (coords, feats, np.asarray(want_c), lower, cond)
    params = init(fm, *args)
    port = load(tp.PointNetFPModule(fp_spec, COND), params,
                lambda p: _shared_mlp_key("mlp.layers", p[1:]))
    with torch.no_grad():
        got = port(*(torch.tensor(a) for a in args))
    close(got, apply(fm, params, *args))


def test_flash_attention_is_not_ported():
    with pytest.raises(NotImplementedError):
        tm.Attention(32, heads=2)


# ---------------------------------------------------------------- bf16
# Both sides hold f32 parameters and compute in bf16 (flax dtype=bf16, the
# port's dtype=torch.bfloat16); inputs are rounded to bf16 first. The two
# frameworks round at other places (flax rounds a Dense before adding its
# bias, and applies AdaGN's affine in bf16; the port adds the bias in the
# f32 accumulator and folds the conv's norm into f32), each rounding worth
# 2^-9 of the value, and a few layers of GroupNorm scale those by up to a
# few times: 2e-2 x max(1, max|out|).
BF16_TOL = 2e-2
BF16 = torch.bfloat16


def bf16_arr(*shape, seed=0, scale=1.0):
    """arr() rounded to bf16 values, as f32 numpy."""
    return torch.from_numpy(arr(*shape, seed=seed, scale=scale)).bfloat16().float().numpy()


def jbf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def close_bf16(got, want):
    if isinstance(got, torch.Tensor):
        assert got.dtype == BF16
        got = got.float()
    close(got, np.asarray(want, np.float32), BF16_TOL)


# BF16_TOL alone would pass a module that computes in f32. The precision
# control: the port's bf16 output loses as much against its f32 twin as
# flax's bf16 output loses against flax at dtype=f32 on the same params,
# within a factor 1.5 (tests/test_torch_model.py BF16_LOSS_RATIO; measured
# 0.86-1.01 here). One module is too shallow to tell rounding points
# apart (a Linear in f32 rounded only at its output still gives 0.79-0.88);
# the backbone test does (0.60 for that, outside the factor).
BF16_LOSS_RATIO = 1.5


def loses_like_flax(got16, got32, want16, want32):
    def rel(a, b):
        a, b = (np.asarray(v.float() if isinstance(v, torch.Tensor) else v, np.float32)
                for v in (a, b))
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    ratio = rel(got16, got32) / rel(want16, want32)
    assert 1 / BF16_LOSS_RATIO <= ratio <= BF16_LOSS_RATIO, ratio


@pytest.mark.parametrize("use_cond", [False, True])
def test_shared_mlp_bf16_matches_jax(use_cond):
    x, cond = bf16_arr(2, 16, 8, 11), bf16_arr(2, COND, seed=1)
    fm = jm.SharedMLP(out_channels=(16, 24), use_cond=use_cond, dtype=jnp.bfloat16)
    params = init(fm, x, cond)
    port, port32 = (load(tm.SharedMLP(11, (16, 24), COND if use_cond else 0, dtype=dt), params,
                         lambda p: _shared_mlp_key("layers", p)) for dt in (BF16, torch.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16(), torch.from_numpy(cond).bfloat16())
        got32 = port32(torch.from_numpy(x), torch.from_numpy(cond))
    want = apply(fm, params, jbf16(x), jbf16(cond))
    close_bf16(got, want)
    fm32 = jm.SharedMLP(out_channels=(16, 24), use_cond=use_cond, dtype=jnp.float32)
    loses_like_flax(got, got32, want, apply(fm32, params, x, cond))


def test_adagn_bf16_matches_jax():
    x, cond = bf16_arr(2, 40, 16, scale=3.0), bf16_arr(2, COND, seed=1)
    fm = jm.AdaGN(num_channels=16, dtype=jnp.bfloat16)
    params = init(fm, x, cond)
    port = load(tm.AdaGN(16, COND, dtype=BF16), params, lambda p: _norm_key("", p)[1:])
    with torch.no_grad():
        close_bf16(port(torch.from_numpy(x).bfloat16(), torch.from_numpy(cond).bfloat16()),
                   apply(fm, params, jbf16(x), jbf16(cond)))
        ga, be = port.affine(torch.from_numpy(cond).bfloat16())
    want_ga, want_be = apply(fm, params, jbf16(x), jbf16(cond), return_affine=True)
    assert ga.dtype == be.dtype == torch.float32  # the folded affine stays f32
    close(ga, want_ga, BF16_TOL)
    close(be, want_be, BF16_TOL)


def test_se_and_linear_attention_bf16_match_jax():
    pooled = bf16_arr(3, 32)
    fm = jm.SE(channels=32, return_gate=True, dtype=jnp.bfloat16)
    params = init(fm, pooled=pooled)
    port = load(tm.SE(32, dtype=BF16), params, lambda p: f"fc.{2 * int(p[0].split('_')[1])}")
    with torch.no_grad():
        close_bf16(port(torch.from_numpy(pooled).bfloat16()), apply(fm, params, pooled=jbf16(pooled)))

    x = bf16_arr(2, 50, 32)
    fm = jm.LinearAttention(dim=32, heads=2, dtype=jnp.bfloat16)
    params = init(fm, x)
    port = load(tm.LinearAttention(32, heads=2, dtype=BF16), params, lambda p: p[0])
    with torch.no_grad():
        close_bf16(port(torch.from_numpy(x).bfloat16()), apply(fm, params, jbf16(x)))


def test_pnet2stage_bf16_matches_jax():
    """At PVDS_PUNet's widths, on f32 unit-sphere coordinates (the
    backbone hands it raw coordinates)."""
    x = arr(2, 256, 3)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    fm = jm.Pnet2Stage(mlp1=(64, 128), mlp2=(256, 512), dtype=jnp.bfloat16)
    params = init(fm, x)

    def key(p):
        m = int(p[0].split("_")[1]) + 1
        k = int(p[1].split("_")[1])
        tail = "0" if p[1].startswith("Dense") else "1.group_norm"
        return f"mlp{m}.shared_mlp_{k}.mlp.{tail}"

    port = load(tm.Pnet2Stage(3, (64, 128), (256, 512), dtype=BF16), params, key)
    with torch.no_grad():
        close_bf16(port(torch.from_numpy(x)), apply(fm, params, x))


@pytest.mark.parametrize("attention", [False, True])
def test_pvconv_bf16_matches_jax(attention):
    spec = jp.PVConvSpec(in_channels=11, out_channels=16, resolution=8, attention=attention)
    feats, coords, cond = bf16_arr(2, 200, 11), arr(2, 200, 3, seed=1, scale=0.5), \
        bf16_arr(2, COND, seed=2)
    fm = jp.PVConv(spec=spec, use_cond=True, attn_heads=2, dtype=jnp.bfloat16)
    params = init(fm, jbf16(feats), coords, jbf16(cond))
    port, port32 = (load(tp.PVConv(spec, cond_dim=COND, attn_heads=2, dtype=dt), params,
                         lambda p: _pvconv_key("", p)[1:]) for dt in (BF16, torch.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(feats).bfloat16(), torch.from_numpy(coords),
                   torch.from_numpy(cond).bfloat16())
        got32 = port32(torch.from_numpy(feats), torch.from_numpy(coords), torch.from_numpy(cond))
    want = apply(fm, params, jbf16(feats), coords, jbf16(cond))
    close_bf16(got, want)
    fm32 = jp.PVConv(spec=spec, use_cond=True, attn_heads=2, dtype=jnp.float32)
    loses_like_flax(got, got32, want, apply(fm32, params, feats, coords, cond))


def test_sa_and_fp_modules_bf16_match_jax():
    feats, coords, cond = bf16_arr(2, 256, 8), arr(2, 256, 3, seed=1, scale=0.4), \
        bf16_arr(2, COND, seed=2)
    sa_spec = jp.SASpec(num_centers=64, radius=0.2, num_neighbors=16, in_channels=8,
                        mlp_channels=(16, 16))
    fm = jp.PointNetSAModule(spec=sa_spec, use_cond=True, dtype=jnp.bfloat16)
    params = init(fm, jbf16(feats), coords, jbf16(cond))
    port = load(tp.PointNetSAModule(sa_spec, COND, dtype=BF16), params,
                lambda p: _shared_mlp_key("mlps.0.layers", p[1:]))
    want_f, want_c = apply(fm, params, jbf16(feats), coords, jbf16(cond))
    with torch.no_grad():
        got_f, got_c = port(torch.from_numpy(feats).bfloat16(), torch.from_numpy(coords),
                            torch.from_numpy(cond).bfloat16())
    close(got_c, want_c)  # centres: f32 FPS on f32 coordinates
    close_bf16(got_f, want_f)

    fp_spec = jp.FPSpec(in_channels=16 + 8, mlp_channels=(16, 8))
    fm = jp.PointNetFPModule(spec=fp_spec, use_cond=True, dtype=jnp.bfloat16)
    lower = np.asarray(want_f, np.float32)
    args = (coords, jbf16(feats), np.asarray(want_c), jbf16(lower), jbf16(cond))
    params = init(fm, *args)
    port = load(tp.PointNetFPModule(fp_spec, COND, dtype=BF16), params,
                lambda p: _shared_mlp_key("mlp.layers", p[1:]))
    targs = (torch.from_numpy(coords), torch.from_numpy(feats).bfloat16(),
             torch.tensor(np.asarray(want_c)), torch.from_numpy(lower).bfloat16(),
             torch.from_numpy(cond).bfloat16())
    with torch.no_grad():
        close_bf16(port(*targs), apply(fm, params, *args))
