"""The port's native host runtime (and its numpy fallback) against the JAX
package's runtime, and the port's host FPS."""

import numpy as np
import pytest

from p2p_bridge_tpu import runtime as jax_runtime
from p2p_bridge_tpu.ops.fps import bucket_fps as jax_bucket_fps
from p2p_bridge_tpu_torch import runtime
from p2p_bridge_tpu_torch.ops.fps import bucket_fps


@pytest.fixture(params=["native", "numpy"])
def port(request, monkeypatch):
    """The port's runtime, with its native library or with the numpy
    fallback that a host with no compiler takes (the JAX package's
    runtime then takes its own)."""
    if request.param == "native":
        assert runtime.get_lib() is not None, "g++ build of the port's runtime failed"
    else:
        monkeypatch.setattr(runtime, "get_lib", lambda: None)
        monkeypatch.setattr(jax_runtime, "get_lib", lambda: None)
    return runtime


def test_the_library_is_built_under_build_keyed_by_the_source():
    path = runtime.library_path()
    assert runtime.get_lib() is not None and path.exists()
    assert path.parent.parent == runtime.BUILD_ROOT
    assert runtime.BUILD_ROOT.parts[-2:] == ("build", "p2p_bridge_tpu_torch_runtime")


def test_accumulate_and_finalize_equal_the_original(port):
    rng = np.random.default_rng(0)
    n_points = 300
    patches = rng.normal(size=(6, 64, 3)).astype(np.float32)
    idxs = rng.integers(0, n_points, size=(6, 64)).astype(np.int64)
    cuts = np.array([64, 10, 3, 64, 0, 33], np.int64)
    got = (np.zeros((n_points, 3)), np.zeros(n_points, np.int64))
    want = (np.zeros((n_points, 3)), np.zeros(n_points, np.int64))
    for _ in range(2):
        port.accumulate_running_mean(*got, patches, idxs, cuts)
        jax_runtime.accumulate_running_mean(*want, patches, idxs, cuts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    fallback = rng.normal(size=(n_points, 3)).astype(np.float32)
    out, misses = port.finalize_running_mean(*got, fallback)
    out_j, misses_j = jax_runtime.finalize_running_mean(*want, fallback)
    np.testing.assert_array_equal(out, out_j)
    assert misses == misses_j == int((got[1] == 0).sum()) > 0


@pytest.mark.parametrize("n,m", [(1, 1), (200, 32), (2000, 500), (5000, 5000)])
def test_fps_host_equals_the_original(port, n, m):
    coords = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    np.testing.assert_array_equal(port.fps_host(coords, m), jax_runtime.fps_host(coords, m))


@pytest.mark.parametrize("n,m,pool", [(20000, 128, None), (3000, 700, None), (9000, 40, 5000),
                                      (4096, 4096, None)])
def test_bucket_fps_host_equals_the_original(port, n, m, pool):
    """The strided pool below n points, exact FPS from there."""
    coords = np.random.default_rng(m).normal(size=(n, 3)).astype(np.float32)
    got = port.bucket_fps_host(coords, m, pool)
    np.testing.assert_array_equal(got, jax_runtime.bucket_fps_host(coords, m, pool))
    assert len(np.unique(got)) == m


def test_bucket_fps_equals_the_original_and_ignores_its_seed():
    coords = np.random.default_rng(3).normal(size=(6000, 3))
    for m in (100, 5999, 6000, 7000):
        got = bucket_fps(coords, m, seed=1)
        np.testing.assert_array_equal(got, jax_bucket_fps(coords, m, seed=1))
        np.testing.assert_array_equal(got, bucket_fps(coords, m, seed=2))
        assert got.dtype == np.int64
    np.testing.assert_array_equal(bucket_fps(coords, 7000), np.arange(6000))
