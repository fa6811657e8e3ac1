"""The JAX package's small public helpers in the port, each against the
original on the same inputs (numpy seeds), on the CPU:
``ops.furthest_point_sample_and_gather``, ``utils.visualize.visualize_voxels``
and ``utils.args.args_to_string``."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_bridge_tpu.ops import furthest_point_sample_and_gather as jax_fps_gather
from p2p_bridge_tpu.utils.args import args_to_string as jax_args_to_string
from p2p_bridge_tpu.utils.config import Config
from p2p_bridge_tpu.utils.visualize import visualize_voxels as jax_visualize_voxels
from p2p_bridge_tpu_torch import ops
from p2p_bridge_tpu_torch.config import pvds_punet
from p2p_bridge_tpu_torch.utils.args import args_to_string
from p2p_bridge_tpu_torch.utils.visualize import visualize_voxels

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("b,n,m", [(1, 33, 1), (2, 100, 17), (3, 512, 128)])
def test_fps_and_gather_equals_jax(b, n, m):
    """The same picked coordinates, bit for bit: the indices are equal and
    the gather copies."""
    coords = np.random.default_rng(n).normal(size=(b, n, 3)).astype(np.float32)
    got = ops.furthest_point_sample_and_gather(torch.tensor(coords), m)
    want = np.asarray(jax_fps_gather(jnp.asarray(coords), m))
    assert got.shape == (b, m, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_args_to_string_equals_jax():
    cfg = pvds_punet()
    cfg["output_dir"] = "runs/PVDS_PUNet"
    assert args_to_string(cfg) == jax_args_to_string(Config(cfg))


@pytest.mark.parametrize("layout", ["brrr", "b1rrr", "brrrc"])
def test_visualize_voxels_draws_what_jax_draws(layout, tmp_path):
    """The same figure as the JAX package's from the same grids: the PNG
    files are byte-equal (both draw with matplotlib's Agg backend)."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(4)
    shape = {"brrr": (4, 4, 4, 4), "b1rrr": (4, 1, 4, 4, 4), "brrrc": (4, 4, 4, 4, 2)}[layout]
    grids = rng.random(shape).astype(np.float32)
    got = visualize_voxels(str(tmp_path / "port.png"), torch.tensor(grids).numpy(), num_shown=4)
    want = jax_visualize_voxels(str(tmp_path / "jax.png"), jnp.asarray(grids), num_shown=4)
    assert got == str(tmp_path / "port.png")
    assert Path(got).read_bytes() == Path(want).read_bytes()
