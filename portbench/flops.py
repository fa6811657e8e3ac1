"""Model FLOPs of one backbone forward, counted from the plan's shapes (a
frozen copy of the program's counter, which ``torch.utils.flop_counter``
bears out on the plain forward).

The standard formulation, what a user's model costs whatever kernels run
it: each 3x3x3 voxel conv 2 * 27 * Cin * Cout a voxel of its r^3 grid;
each Linear 2 * Cin * Cout a row (the point-wise layers a point, the
grouped SA layers a (centre, neighbour) pair, the conditioning layers a
cloud); the linear attention's two contractions. Normalisations,
activations, the point operations and the sampler's arithmetic are left
out.
"""

from __future__ import annotations

from .reference.plan import plan_from_config

DIM_HEAD = 32


def linear(rows: int, cin: int, cout: int) -> int:
    return 2 * rows * cin * cout


def conv3(batch: int, r: int, cin: int, cout: int) -> int:
    return 2 * 27 * cin * cout * batch * r ** 3


def shared_mlp(rows: int, batch: int, cin: int, widths, cond_dim: int) -> int:
    total = 0
    for oc in widths:
        total += linear(rows, cin, oc) + (linear(batch, cond_dim, 2 * oc) if cond_dim else 0)
        cin = oc
    return total


def linear_attention(batch: int, n: int, dim: int, heads: int) -> int:
    inner = heads * DIM_HEAD
    return (linear(batch * n, dim, 3 * inner) + linear(batch * n, inner, dim)
            + 2 * (2 * batch * heads * n * DIM_HEAD * DIM_HEAD))


def pvconv(spec, batch: int, n: int, cond_dim: int, use_se: bool, heads: int) -> int:
    cin, cout, r = spec.in_channels, spec.out_channels, spec.resolution
    total = conv3(batch, r, cin, cout) + conv3(batch, r, cout, cout)
    if cond_dim:
        total += 2 * linear(batch, cond_dim, 2 * cout)
    if use_se:
        total += linear(batch, cout, cout // 8) + linear(batch, cout // 8, cout)
    total += shared_mlp(batch * n, batch, cin, (cout,), cond_dim)
    if spec.attention:
        total += linear_attention(batch, n, cout, heads)
    return total


def forward_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one forward of the configuration's backbone on ``batch``
    clouds of ``data.npoints`` points."""
    model = cfg["model"]
    pvd = model["PVD"]
    if pvd.get("attention_type", "linear").lower() != "linear":
        raise NotImplementedError("the counter knows the linear attention only")
    plan = plan_from_config(cfg)
    n = cfg["data"]["npoints"]
    rows = batch * n
    input_dim = model.get("in_dim", 3)
    extra = pvd.get("extra_feature_channels", model.get("extra_feature_channels", 0))
    f_embed = pvd.get("feat_embed_dim", extra)
    embed_dim = model.get("time_embed_dim", 64)
    heads = pvd.get("attention_heads", 4)
    use_se = pvd.get("use_se", True)
    total = 0
    if f_embed != extra:
        src = input_dim if extra == 0 else extra
        total += linear(rows, src, f_embed) + linear(rows, f_embed, f_embed)
    cond_dim = 0
    if pvd.get("use_global_embedding", False):
        c = pvd.get("global_embedding_dim", 1024)
        total += (linear(rows, input_dim, c // 8) + linear(rows, c // 8, c // 4)
                  + linear(rows, c // 2, c // 2) + linear(rows, c // 2, c))
        cond_dim = c
    total += 2 * linear(batch, embed_dim, embed_dim)
    points = []
    for stage in plan.sa_stages:
        points.append(n)
        total += sum(pvconv(s, batch, n, cond_dim, use_se, heads) for s in stage.convs)
        sa = stage.sa
        total += shared_mlp(batch * sa.num_centers * sa.num_neighbors, batch,
                            sa.in_channels + 3, sa.mlp_channels, cond_dim)
        n = sa.num_centers
    total += linear_attention(batch, n, plan.bottleneck_channels, heads)
    for stage, fine in zip(plan.fp_stages, reversed(points)):
        total += shared_mlp(batch * fine, batch, stage.fp.in_channels, stage.fp.mlp_channels,
                            cond_dim)
        total += sum(pvconv(s, batch, fine, cond_dim, use_se, heads) for s in stage.convs)
    last = plan.fp_stages[-1]
    head_in = last.convs[-1].out_channels if last.convs else last.fp.mlp_channels[-1]
    total += shared_mlp(rows, batch, head_in, (plan.out_mlp,), 0)
    total += linear(rows, plan.out_mlp, model.get("out_dim", 3))
    return total
