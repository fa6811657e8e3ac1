"""The deterministic backward scatter of K3, K4 and K6 (kernel
``scatter_rows``, ``csrc/scatter_rows.cu``).

Each backward adds weighted gradient rows into destination rows: per cloud,
destination row v is the f32 sum, in ascending entry order, of the terms of
the entries whose destination is v, rounded once to the gradient's dtype.
The plain versions (``index_add_`` in ``devoxelize.py``, ``ball_query.py``
and ``interpolate.py``) add the entries one after another in entry order on
the CPU (``tests/test_torch_scatter.py`` pins that order), and the kernel
sums each row's entries in that order, so its output is bit-equal to the
plain version's on the CPU and the same from run to run.

The kernel is two launches. The first builds each cloud's segment table
(the entries sorted stably by destination, each row's first slot) with a
radix sort on the destination, 8 bits a pass, in one thread block cluster
of up to 16 CTAs a cloud; the second sums each row's segment, one thread
per 16 bytes of the output. Its limits (``check_scatter_shape``): 2^20
entries and 2^16 rows a cloud, no more clouds than a grid dimension takes,
32-bit offsets. The wrappers call :func:`scatter_rows_cuda` for a CUDA
tensor only.
"""

from __future__ import annotations

import torch

from .. import kernels

GATHER, INTERP, DEVOX = 0, 1, 2  # K4, K6, K3
MAX_ENTRIES = 1 << 20  # a cloud's entries (a 131,072-point cloud's K3 backward)
MAX_ROWS = 1 << 16  # two 8-bit digit passes of the table's radix sort


def check_scatter_shape(B: int, S: int, E: int, R: int, C: int) -> None:
    """Raise unless the kernel takes this shape: 1 <= E <= 2^20 entries and
    1 <= R <= 2^16 destination rows a cloud, 1 <= B < 65536 clouds and S *
    C, R * C below 2^31 (32-bit offsets). Every backward of the three
    configs' training shapes qualifies (at most 8 x 4096 corners, 1024 x 32
    gathered rows and r^3 = 32,768), and so does K3's backward of a
    16,384-point patch (2^17 entries)."""
    if not (1 <= E <= MAX_ENTRIES and 1 <= R <= MAX_ROWS and 1 <= B < 2 ** 16
            and C >= 1 and max(S, R) * C < 2 ** 31):
        raise ValueError(f"scatter_rows kernel takes 1 <= E <= {MAX_ENTRIES} entries and "
                         f"1 <= R <= {MAX_ROWS} rows a cloud, 1 <= B < 65536 and S * C, "
                         f"R * C below 2^31; got B={B}, S={S}, E={E}, R={R}, C={C}")


def scatter_rows_cuda(mode: int, grad: torch.Tensor, rows: int, idx=None, weights=None,
                      coords=None, resolution: int = 0) -> torch.Tensor:
    """grad [B, S, C] f32 or bf16 -> [B, rows, C] of grad's dtype.

    GATHER: idx [B, S] int32 (entry e is grad row e). INTERP: idx and
    weights [B, 3S] int32 and f32 (entry e is grad row e // 3 times its
    weight). DEVOX: coords [B, S, 3] f32, rows = resolution^3 (entry
    c * S + n is corner c of point n)."""
    B, S, C = grad.shape
    E = {GATHER: S, INTERP: 3 * S, DEVOX: 8 * S}[mode]
    check_scatter_shape(B, S, E, rows, C)
    specs = [("grad", grad, kernels.DATA, (B, S, C))]
    if mode == DEVOX:
        specs.append(("coords", coords, torch.float32, (B, S, 3)))
    else:
        specs.append(("idx", idx, torch.int32, (B, E)))
    if mode == INTERP:
        specs.append(("weights", weights, torch.float32, (B, E)))
    device = kernels.check(*specs)
    if grad.data_ptr() % 16:  # read as 16-byte vectors
        grad = grad.clone()
    out = grad.new_empty((B, rows, C))
    # the table's scratch: (entry, destination) pairs between the sort's
    # passes [B, E, 2], the sorted entry order [B, E], segment starts
    # [B, rows + 1]; written before read, so not zeroed
    tables = grad.new_empty(B * (3 * E + rows + 1), dtype=torch.int32)
    kernels.launch(
        "scatter_rows", "p2pb_scatter_rows", device, grad.data_ptr(),
        None if idx is None else idx.data_ptr(),
        None if weights is None else weights.data_ptr(),
        None if coords is None else coords.data_ptr(), mode, B, S, E, rows, C, resolution,
        int(grad.dtype == torch.bfloat16), out.data_ptr(), tables.data_ptr())
    return out
