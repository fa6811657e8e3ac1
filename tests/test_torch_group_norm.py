"""The point branch's fused GroupNorm (``ops/group_norm.py``,
``csrc/group_norm.cu``) on the CPU: its plain formulation, its shape
limits, its route under autograd (on a pretended card, the kernel stood in
for by the plain formulation), and a numpy model of the kernel's partition
of the work.

The model follows the kernel's index arithmetic line by line (block
chunks, a thread's column and rows, the shared-memory layout of the block's
sums, the warp-per-group reduction, the partials' layout and the apply
pass), with its constants parsed from the source, on integer-valued inputs:
sums of integers are exact in double, so a row or channel counted twice or
missed shows as an inequality, and a shared-memory entry read before it is
written shows as NaN. No jax; seconds.
"""

import re

import numpy as np
import pytest
import torch

from p2p_bridge_tpu_torch import kernels
from p2p_bridge_tpu_torch.ops import group_norm as gn_ops

SOURCE = (kernels.CSRC / "group_norm.cu").read_text()


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS, MAX_CHUNKS, MAX_GROUPS = constant("kThreads"), constant("kMaxChunks"), constant("kMaxGroups")
# resident block slots of (the partials kernel, the apply kernel): 132 SMs x
# 4 and x 3 blocks, the occupancies ptxas's registers and shared memory give
# the bf16 kernels on an H100
SLOTS = (528, 396)


def test_the_wrapper_shares_the_kernels_constants():
    assert (gn_ops.THREADS, gn_ops.MAX_CHUNKS, gn_ops.MAX_GROUPS) == (
        THREADS, MAX_CHUNKS, MAX_GROUPS)


def chunks(B: int, passes: int, slots: int) -> int:
    """The kernel's ``chunks``: of S in [1, min(MAX_CHUNKS, passes)], the
    fewest whose B * S blocks fill 90% of their waves of ``slots``, else the
    best filler."""
    best, best_used, best_slots = 1, 0, 1
    for s in range(1, min(MAX_CHUNKS, max(passes, 1)) + 1):
        blocks = B * s
        waves = -(-blocks // slots)
        if 10 * blocks >= 9 * waves * slots:
            return s
        if blocks * best_slots > best_used * waves * slots:
            best, best_used, best_slots = s, blocks, waves * slots
    return best


def model(x: np.ndarray, gamma: np.ndarray, beta: np.ndarray, groups: int, eps: float,
          act: bool, dtype: torch.dtype, slots: tuple = SLOTS):
    """(y, partials, writes) as the two kernels compute them, in float64:
    x [B, L, C], gamma / beta [B, C] (a shared affine is the stride-0 case)."""
    B, L, C = x.shape
    vec = gn_ops.vector_channels(C, dtype)
    CV = C // vec
    RP = THREADS // CV
    passes = -(-L // RP)
    S = chunks(B, passes, slots[0])
    rows = -(-L // S)
    gs, flat = C // groups, x.reshape(B, L * C)
    partials = np.full(B * groups * MAX_CHUNKS * 2, np.nan)  # the wrapper's scratch
    for b in range(B):
        for s in range(S):
            lo, hi = s * rows, min(L, s * rows + rows)
            red = np.full(THREADS * vec * 2, np.nan)
            for tid in range(THREADS):
                r0, col = tid // CV, tid % CV
                if r0 >= RP:
                    continue
                vals = np.array([[flat[b, r * C + col * vec + i] for i in range(vec)]
                                 for r in range(lo + r0, hi, RP)]).reshape(-1, vec)
                for i in range(vec):
                    red[tid * vec * 2 + 2 * i] = vals[:, i].sum()
                    red[tid * vec * 2 + 2 * i + 1] = (vals[:, i] ** 2).sum()
            n = RP * gs
            for warp in range(THREADS // 32):
                for g in range(warp, groups, THREADS // 32):
                    s1 = s2 = 0.0
                    for lane in range(32):
                        for e in range(lane, n, 32):
                            p = ((e // gs) * C + g * gs + e % gs) * 2
                            s1, s2 = s1 + red[p], s2 + red[p + 1]
                    pp = ((b * groups + g) * S + s) * 2
                    partials[pp], partials[pp + 1] = s1, s2
    y = np.full(B * L * C, np.nan)
    writes = np.zeros(B * L * C, np.int64)
    count = L * gs
    S2 = chunks(B, passes, slots[1])
    rows2 = -(-L // S2)
    for b in range(B):
        st = []
        for g in range(groups):
            pp = partials[(b * groups + g) * S * 2:][:S * 2]
            m = pp[0::2].sum() / count
            v = max(pp[1::2].sum() / count - m * m, 0.0)
            st.append((m, 1.0 / np.sqrt(v + eps)))
        for s in range(S2):
            lo, hi = s * rows2, min(L, s * rows2 + rows2)
            for tid in range(RP * CV):
                r0, col = tid // CV, tid % CV
                c0 = col * vec
                for r in range(lo + r0, hi, RP):
                    for i in range(vec):
                        m, rstd = st[(c0 + i) // gs]
                        z = (flat[b, r * C + c0 + i] - m) * rstd * gamma[b, c0 + i] + beta[b, c0 + i]
                        y[(b * L + r) * C + c0 + i] = z / (1 + np.exp(-z)) if act else z
                        writes[(b * L + r) * C + c0 + i] += 1
    return y.reshape(x.shape), partials[:B * groups * S * 2].reshape(B, groups, S, 2), writes


def plain64(x, gamma, beta, groups, eps, act):
    B, L, C = x.shape
    xg = x.reshape(B, L, groups, C // groups)
    m = xg.mean(axis=(1, 3), keepdims=True)
    v = np.maximum((xg * xg).mean(axis=(1, 3), keepdims=True) - m * m, 0.0)
    z = ((xg - m) / np.sqrt(v + eps)).reshape(x.shape) * gamma[:, None] + beta[:, None]
    return z / (1 + np.exp(-z)) if act else z


# (B, L, C, groups, dtype): 16-byte vectors with a group narrower than a
# vector (32 / 8 in bf16), MyGroupNorm's 32 groups, C / VEC not dividing the
# block (48 / 8 = 6 columns, 42 rows a pass), vectors of 4, 2 and 1 channels
# (36, 70 and 35 bf16 channels), rows fewer than a pass, a cloud cut into
# the most chunks, the widest rows (1024 bf16: 128 columns)
SHAPES = [(3, 100, 32, 8, torch.bfloat16), (2, 64, 64, 32, torch.bfloat16),
          (2, 300, 48, 8, torch.bfloat16), (2, 50, 36, 4, torch.bfloat16),
          (1, 40, 70, 5, torch.bfloat16), (2, 9, 35, 7, torch.bfloat16),
          (1, 5000, 8, 8, torch.float32), (2, 37, 16, 8, torch.float32),
          (1, 70, 1024, 32, torch.bfloat16), (2, 40, 1024, 8, torch.float32)]


@pytest.mark.parametrize("B,L,C,groups,dtype", SHAPES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_kernel_model_counts_every_value_once(B, L, C, groups, dtype):
    """At the card's slots and at few slots (many chunks a cloud, the two
    passes chunked apart)."""
    rng = np.random.default_rng(C + L)
    x = rng.integers(-8, 9, size=(B, L, C)).astype(np.float64)
    gamma, beta = rng.normal(size=(B, C)), rng.normal(size=(B, C))
    y, partials, writes = model(x, gamma, beta, groups, 1e-5, True, dtype,
                                SLOTS if (C + L) % 2 else (29, 7))
    xg = x.reshape(B, L, groups, C // groups)
    assert np.array_equal(partials[..., 0].sum(-1), xg.sum(axis=(1, 3)))
    assert np.array_equal(partials[..., 1].sum(-1), (xg * xg).sum(axis=(1, 3)))
    assert (writes == 1).all()
    np.testing.assert_allclose(y, plain64(x, gamma, beta, groups, 1e-5, True), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("B,slots,S", [(73, 528, 7), (73, 396, 5), (32, 528, 15), (32, 396, 12),
                                        (292, 528, 5), (1, 528, 32), (4, 396, 32)])
def test_chunks_fill_the_waves(B, slots, S):
    """A 50k object (B = 73), a room batch (32) and four objects (292) fill
    90% of their waves; a cloud or four that cannot take the most chunks."""
    assert chunks(B, 1000, slots) == S
    blocks = B * S
    assert blocks >= 0.9 * -(-blocks // slots) * slots or S == MAX_CHUNKS
    assert chunks(B, 3, slots) <= 3


@pytest.mark.parametrize("C,dtype,vec", [(64, torch.bfloat16, 8), (36, torch.bfloat16, 4),
                                         (70, torch.bfloat16, 2), (35, torch.bfloat16, 1),
                                         (64, torch.float32, 4), (6, torch.float32, 2)])
def test_vector_channels(C, dtype, vec):
    assert gn_ops.vector_channels(C, dtype) == vec


@pytest.mark.parametrize("B,C,groups,dtype", [(2, 30, 8, torch.float32), (2, 2048, 2048, torch.bfloat16),
                                              (2, 2056, 8, torch.bfloat16), (2, 1028, 4, torch.float32),
                                              (2, 514, 2, torch.bfloat16), (65536, 32, 8, torch.float32),
                                              (0, 32, 8, torch.float32)])
def test_shapes_the_kernel_refuses(B, C, groups, dtype):
    with pytest.raises(ValueError, match="group_norm_act takes"):
        gn_ops.check_group_norm_shape(B, C, groups, dtype)


@pytest.mark.parametrize("B,C,groups,dtype", [(73, 32, 8, torch.bfloat16), (32, 1024, 32, torch.bfloat16),
                                              (1, 1024, 8, torch.float32), (4, 2048, 8, torch.bfloat16),
                                              (2, 256, 256, torch.bfloat16), (1, 35, 5, torch.float32)])
def test_shapes_the_kernel_takes(B, C, groups, dtype):
    gn_ops.check_group_norm_shape(B, C, groups, dtype)


@pytest.mark.parametrize("shape,per_cloud", [((2, 40, 16), True), ((2, 3, 5, 16), False)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plain_formulation_rounds_once(shape, per_cloud, out_dtype):
    """The plain formulation is the f32 result (statistics, affine, swish)
    rounded once to ``out_dtype``, from bf16 or f32 inputs."""
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(shape, generator=g) * 3 + 1).bfloat16()
    affine = (shape[0], shape[-1]) if per_cloud else (shape[-1],)
    gamma, beta = torch.randn(affine, generator=g), torch.randn(affine, generator=g)
    got = gn_ops.group_norm_act_plain(x, gamma, beta, 4, 1e-5, True, out_dtype)
    xd = x.double().reshape(shape[0], -1, shape[-1]).numpy()
    gd = gamma.double().expand(shape[0], shape[-1]).numpy()
    bd = beta.double().expand(shape[0], shape[-1]).numpy()
    want = torch.from_numpy(plain64(xd, gd, bd, 4, 1e-5, True)).reshape(shape)
    assert got.dtype == out_dtype and got.shape == x.shape
    tol = 2.0 ** -8 if out_dtype == torch.bfloat16 else 1e-5
    assert ((got.double() - want).abs() <= tol * want.abs().clamp_min(1.0)).all()


def test_group_norm_act_on_the_cpu_is_the_plain_formulation():
    g = torch.Generator().manual_seed(2)
    x, gamma, beta = torch.randn(2, 7, 32, generator=g), torch.randn(32), torch.randn(32)
    want = gn_ops.group_norm_act_plain(x, gamma, beta, 8, 1e-5, True, torch.bfloat16)
    assert torch.equal(gn_ops.group_norm_act(x, gamma, beta, 8, 1e-5, True, torch.bfloat16), want)
    assert gn_ops.group_norm_act(x, gamma, beta, 8).dtype == torch.float32


def test_affine_tables_are_read_by_their_row_stride():
    """A shared [C] table has stride 0; a per-cloud [B, C] table, contiguous
    or a column slice of a wider one (AffineBank's), is read in place by its
    row stride; any other layout is copied first, or refused."""
    table = torch.zeros(3, 40)
    assert kernels.affine_stride("g", torch.zeros(16), 3, 16, table.device) == 0
    assert kernels.affine_stride("g", torch.zeros(3, 16), 3, 16, table.device) == 16
    assert kernels.affine_stride("g", table[:, 8:24], 3, 16, table.device) == 40
    assert kernels.affine_operand(table[:, 8:24]) is not None
    assert kernels.affine_operand(table[:, 8:24]).data_ptr() == table[:, 8:24].data_ptr()
    for bad in (torch.zeros(16, 3).t(), torch.zeros(16).expand(3, 16)):
        with pytest.raises(ValueError, match="contiguous"):
            kernels.affine_stride("g", bad, 3, 16, table.device)
        fixed = kernels.affine_operand(bad)
        assert fixed.is_contiguous() and torch.equal(fixed, bad)
    with pytest.raises(TypeError):
        kernels.affine_stride("g", torch.zeros(3, 16, dtype=torch.float64), 3, 16, table.device)
    with pytest.raises(ValueError, match="shape"):
        kernels.affine_stride("g", torch.zeros(2, 16), 3, 16, table.device)


def test_the_kernels_take_an_affine_row_stride():
    """Both entries take the row stride of the affine tables (0: shared),
    and refuse one below C."""
    for entry in ("p2pb_group_norm_act", "p2pb_conv3d_gn"):
        src = (kernels.CSRC / ("group_norm.cu" if entry == "p2pb_group_norm_act"
                               else "conv3d_gn.cu")).read_text()
        head = src[src.index(f"P2PB_API int {entry}("):]
        assert "int affine_stride," in head[:head.index(")")]
        assert "affine_stride && affine_stride <" in head


# ------------------------------------------------ the route under autograd
@pytest.fixture
def pretend_card(monkeypatch):
    """CPU tensors count as on the card; the kernel is stood in for by the
    plain formulation, and each call is recorded."""
    calls = []

    def kernel(x, gamma, beta, groups, eps, act, out_dtype):
        calls.append(tuple(x.shape))
        return gn_ops.group_norm_act_plain(x, gamma, beta, groups, eps, act, out_dtype)

    monkeypatch.setattr(kernels, "on_card", lambda t: True)
    monkeypatch.setattr(gn_ops, "_group_norm_act_cuda", kernel)
    return calls


def autograd_inputs(dtype, affine, seed=5, B=3, C=32):
    """x [B, 7, 5, C] of ``dtype`` and an f32 affine: "shared" [C],
    "per_cloud" [B, C], or "bank_column", gamma and beta column slices of
    one wider [B, 4C] table (as AffineBank hands them); each leaf wants a
    gradient. -> (x, gamma, beta, leaves)."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, 7, 5, C, generator=g) * 2 + 0.5).to(dtype).requires_grad_(True)
    if affine == "bank_column":
        table = torch.randn(B, 4 * C, generator=g).requires_grad_(True)
        return x, table[:, C:2 * C], table[:, 2 * C:3 * C], [x, table]
    shape = (C,) if affine == "shared" else (B, C)
    gamma = (torch.randn(shape, generator=g) * 0.3 + 1).requires_grad_(True)
    beta = torch.randn(shape, generator=g).requires_grad_(True)
    return x, gamma, beta, [x, gamma, beta]


@pytest.mark.parametrize("act", [False, True], ids=["norm", "norm_swish"])
@pytest.mark.parametrize("affine", ["shared", "per_cloud", "bank_column"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_card_route_under_autograd_is_the_kernel_with_the_plain_gradients(
        dtype, affine, act, pretend_card):
    """On the card with a gradient wanted, the forward is one kernel call
    and the backward calls none: the gradients of x and of the affine (a
    column slice of a wider table included) equal autograd's through the
    plain formulation."""
    x, gamma, beta, leaves = autograd_inputs(dtype, affine)
    got = gn_ops.group_norm_act(x, gamma, beta, 8, 1e-5, act)
    assert pretend_card == [tuple(x.shape)] and got.grad_fn is not None
    want = gn_ops.group_norm_act_plain(x, gamma, beta, 8, 1e-5, act)
    assert got.dtype == dtype and torch.equal(got, want)
    weight = torch.randn(got.shape, generator=torch.Generator().manual_seed(9))
    g_got = torch.autograd.grad((got.float() * weight).sum(), leaves)
    g_want = torch.autograd.grad((want.float() * weight).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))
    assert len(pretend_card) == 1


@pytest.mark.parametrize("wanted", [("x",), ("gamma",), ("beta",), ("gamma", "beta")],
                         ids="+".join)
def test_the_card_route_gives_only_the_wanted_gradients(wanted, pretend_card):
    """Where only some of x, gamma and beta want a gradient (bf16 x, an f32
    output), the kernel still runs the forward and the backward gives
    those gradients, each equal to the plain formulation's."""
    x, gamma, beta, _ = autograd_inputs(torch.bfloat16, "per_cloud")
    named = {"x": x.detach(), "gamma": gamma.detach(), "beta": beta.detach()}
    for name in wanted:
        named[name].requires_grad_(True)
    args = (named["x"], named["gamma"], named["beta"], 8, 1e-5, True, torch.float32)
    got = gn_ops.group_norm_act(*args)
    want = gn_ops.group_norm_act_plain(*args)
    assert len(pretend_card) == 1 and got.dtype == torch.float32 and torch.equal(got, want)
    weight = torch.randn(got.shape, generator=torch.Generator().manual_seed(9))
    leaves = [named[name] for name in wanted]
    g_got = torch.autograd.grad((got * weight).sum(), leaves)
    g_want = torch.autograd.grad((want * weight).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))


@pytest.mark.parametrize("no_grad", [True, False], ids=["no_grad", "nothing_wanted"])
def test_the_card_route_without_a_gradient_makes_no_autograd_node(no_grad, pretend_card):
    """Under no_grad, or where no input wants a gradient, the kernel runs
    alone: no autograd node, nothing saved."""
    x, gamma, beta, _ = autograd_inputs(torch.bfloat16, "shared")
    if not no_grad:
        x, gamma, beta = x.detach(), gamma.detach(), beta.detach()
    with torch.set_grad_enabled(not no_grad):
        got = gn_ops.group_norm_act(x, gamma, beta, 8, 1e-5, True)
    assert len(pretend_card) == 1 and got.grad_fn is None and not got.requires_grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_cpu_route_under_autograd_is_the_plain_formulation(dtype, monkeypatch):
    """On the CPU a gradient wanted never reaches the kernel: the op is the
    plain formulation, which autograd differentiates."""
    def kernel(*args):
        raise AssertionError("the kernel was reached from the CPU")

    monkeypatch.setattr(gn_ops, "_group_norm_act_cuda", kernel)
    x, gamma, beta, leaves = autograd_inputs(dtype, "per_cloud")
    got = gn_ops.group_norm_act(x, gamma, beta, 8, 1e-5, True)
    want = gn_ops.group_norm_act_plain(x, gamma, beta, 8, 1e-5, True)
    assert torch.equal(got, want)
    weight = torch.randn(got.shape, generator=torch.Generator().manual_seed(9))
    g_got = torch.autograd.grad((got.float() * weight).sum(), leaves)
    g_want = torch.autograd.grad((want.float() * weight).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))
