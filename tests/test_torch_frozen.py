"""The frozen-weights scope (``utils/frozen.py``) and what the sampler
derives once in it: each Linear's cast weights, K1's weight layout, the
voxel coordinates, and the AdaGNs' affines (``modules.AffineBank``). On the
CPU the model gives the same bits in the scope as out of it. No jax."""

import pytest
import torch

from p2p_bridge_tpu_torch.config import pvds_punet
from p2p_bridge_tpu_torch.models import modules as tm
from p2p_bridge_tpu_torch.models.unet_pvc import build_unet_from_config, init_parameters
from p2p_bridge_tpu_torch.utils import frozen
from p2p_bridge_tpu_torch.utils.frozen import frozen_weights, once


def counting():
    made = []

    def make(t):
        made.append(1)
        return t * 2

    return made, make


def test_once_makes_once_in_the_scope_and_at_every_call_outside():
    t = torch.ones(3)
    made, make = counting()
    once(t, "a", make)
    once(t, "a", make)
    assert len(made) == 2 and not frozen.active()
    with torch.no_grad(), frozen_weights():
        assert frozen.active()
        first = once(t, "a", make)
        assert once(t, "a", make) is first and len(made) == 3
        once(t, "b", make)  # another tag
        with frozen_weights():  # a nested scope shares the outer one's values
            assert once(t, "a", make) is first
        assert len(made) == 4
    assert not frozen.active()
    with torch.no_grad(), frozen_weights():  # a new scope makes anew
        assert once(t, "a", make) is not first


def test_once_makes_at_every_call_where_a_gradient_is_wanted():
    t = torch.ones(3, requires_grad=True)
    made, make = counting()
    with frozen_weights():
        out = once(t, "a", make)
        once(t, "a", make)
    assert len(made) == 2 and out.requires_grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_bank_gives_each_adagn_its_own_affine(dtype):
    """AffineBank's column views equal each AdaGN's affine bit for bit (the
    same operations on the stacked weights), with the tables' row stride."""
    g = torch.Generator().manual_seed(0)
    adagns = [tm.AdaGN(c, 24, dtype=dtype) for c in (32, 64, 16)]
    with torch.no_grad():
        for m in adagns:
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
    bank = tm.AffineBank(adagns)
    cond = torch.randn(5, 24, generator=g).to(dtype)
    with torch.no_grad(), frozen_weights():
        for m in adagns:
            gamma, beta = bank.affine(m, cond)
            want = m.affine(cond)  # on the CPU AdaGN computes its own
            assert gamma.stride() == beta.stride() == (112, 1)
            assert torch.equal(gamma, want[0]) and torch.equal(beta, want[1])
        assert bank.affine(adagns[0], cond)[0].data_ptr() == gamma.data_ptr() - 96 * 4


def test_the_model_holds_one_bank_of_every_adagn():
    model = build_unet_from_config(pvds_punet())
    adagns = [m for m in model.modules() if isinstance(m, tm.AdaGN)]
    assert adagns and {id(m.bank) for m in adagns} == {id(adagns[0].bank)}
    assert adagns[0].bank.adagns == adagns


def tiny_model():
    cfg = pvds_punet()
    cfg["model"].update(time_embed_dim=16)
    cfg["data"]["npoints"] = 256
    cfg["model"]["PVD"].update(
        global_embedding_dim=64, feat_embed_dim=8, attention_heads=2, channels=[32, 32, 32, 64, 64],
        voxel_resolutions=[8, 4, 4, 4], n_sa_blocks=[1, 1, 1, 1], n_fp_blocks=[1, 1, 1, 1],
        radius=[0.2, 0.4, 0.8, 1.2], out_mlp=32)
    cfg["model"]["compute_dtype"] = "bf16"
    return init_parameters(build_unet_from_config(cfg), torch.Generator().manual_seed(1)).eval()


def test_the_model_gives_the_same_bits_in_the_scope():
    """Two forwards inside one scope (the second reuses the first's casts)
    equal forwards outside it, on the CPU."""
    model = tiny_model()
    g = torch.Generator().manual_seed(2)
    x = [torch.randn(2, 256, 3, generator=g) * 0.4 for _ in range(2)]
    t = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        want = [model(xi, t) for xi in x]
        with frozen_weights():
            got = [model(xi, t) for xi in x]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
