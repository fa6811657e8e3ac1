"""Native host runtime of the room path (a copy of
p2p_bridge_tpu/runtime/__init__.py; tests hold the two equal).

``native/recompose.cpp`` (byte-equal to the JAX package's) compiles with
g++ into ``build/p2p_bridge_tpu_torch_runtime/<hash>/librecompose.so`` at
the repository root on first use, keyed by a hash of the source, the flags
and the host CPU that ``-march=native`` resolves to, so a library built on
one machine is never loaded on another. It is loaded with ctypes. Every
entry point has a numpy fallback for a host with no compiler; a failed
build logs a warning and takes it.

  * accumulate_running_mean / finalize_running_mean: the room's
    overlap-averaged recomposition,
  * fps_host / bucket_fps_host: host furthest point sampling for the
    room's seeding and the patch split.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("p2pb")

_SRC = Path(__file__).resolve().parent / "native" / "recompose.cpp"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")  # the JAX package's build
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "p2p_bridge_tpu_torch_runtime"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library for this source, these flags and this host's CPU
    lives (raises where g++ cannot be run)."""
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                            capture_output=True, check=True, timeout=60).stdout
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(target)
    return BUILD_ROOT / h.hexdigest()[:16] / "librecompose.so"


def _build() -> Optional[Path]:
    """The library, compiled unless it exists; None where g++ fails."""
    try:
        out = library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
                lib = os.path.join(tmp, "lib.so")
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", lib], check=True,
                               capture_output=True, timeout=120)
                os.replace(lib, out)  # atomic: a concurrent build sees whole files only
        return out
    except (OSError, subprocess.SubprocessError) as e:  # no toolchain -> numpy fallback
        logger.warning("native runtime build failed (%s); using numpy fallback", e)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (the numpy fallback)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.accumulate_running_mean.argtypes = [f64p, i64p, f32p, i64p, i64p, i64, i64, i64]
        lib.accumulate_running_mean.restype = None
        lib.finalize_running_mean.argtypes = [f64p, i64p, f32p, f32p, i64]
        lib.finalize_running_mean.restype = i64
        lib.fps_host.argtypes = [f32p, i64, i64, i64p, f32p]
        lib.fps_host.restype = None
        lib.bucket_fps_host.argtypes = [f32p, i64, i64, i64, i64p, f32p, i64p]
        lib.bucket_fps_host.restype = None
        _lib = lib
        return _lib


# ------------------------------------------------------------- wrappers
def accumulate_running_mean(
    sums: np.ndarray,
    counts: np.ndarray,
    patches: np.ndarray,
    idxs: np.ndarray,
    cuts: np.ndarray,
) -> None:
    """In-place accumulation of patch predictions (sums f64, counts i64)."""
    patches = np.ascontiguousarray(patches, np.float32)
    idxs = np.ascontiguousarray(idxs, np.int64)
    cuts = np.ascontiguousarray(cuts, np.int64)
    lib = get_lib()
    if lib is not None:
        lib.accumulate_running_mean(
            sums, counts, patches, idxs, cuts,
            patches.shape[0], patches.shape[1], sums.shape[0],
        )
        return
    for patch, pid, cut in zip(patches, idxs, cuts):
        p, i = patch[: int(cut)], pid[: int(cut)]
        np.add.at(sums, i, p.astype(np.float64))
        np.add.at(counts, i, 1)


def finalize_running_mean(
    sums: np.ndarray, counts: np.ndarray, fallback: np.ndarray
) -> Tuple[np.ndarray, int]:
    """Returns (means-with-fallback float32 [N, 3], n_never_updated)."""
    fallback = np.ascontiguousarray(fallback, np.float32)
    out = np.empty_like(fallback)
    lib = get_lib()
    if lib is not None:
        misses = int(lib.finalize_running_mean(sums, counts, fallback, out, len(out)))
        return out, misses
    mask = counts > 0
    out[:] = fallback
    out[mask] = (sums[mask] / counts[mask, None]).astype(np.float32)
    return out, int((~mask).sum())


def fps_host(coords: np.ndarray, num_samples: int) -> np.ndarray:
    """Exact sequential FPS on the host. coords [N, 3] -> [M] int64."""
    coords = np.ascontiguousarray(coords, np.float32)
    n = coords.shape[0]
    m = min(num_samples, n)
    lib = get_lib()
    if lib is not None:
        out = np.empty(m, np.int64)
        dists = np.empty(n, np.float32)
        lib.fps_host(coords, n, m, out, dists)
        return out
    out = np.zeros(m, np.int64)
    dists = np.full(n, np.inf, np.float32)
    last = 0
    for j in range(1, m):
        d = np.sum((coords - coords[last]) ** 2, -1)
        np.minimum(dists, d, out=dists)
        last = int(np.argmax(dists))
        out[j] = last
    return out


def bucket_fps_host(coords: np.ndarray, num_samples: int,
                    pool_size: Optional[int] = None) -> np.ndarray:
    """Approximate FPS over a strided candidate pool for huge clouds."""
    coords = np.ascontiguousarray(coords, np.float32)
    n = coords.shape[0]
    m = min(num_samples, n)
    if pool_size is None:
        pool_size = min(n, max(4 * m, 4096))
    lib = get_lib()
    if lib is not None:
        out = np.empty(m, np.int64)
        dists = np.empty(max(n, pool_size), np.float32)
        pool = np.empty(pool_size, np.int64)
        lib.bucket_fps_host(coords, n, m, pool_size, out, dists, pool)
        return out
    if pool_size >= n:
        return fps_host(coords, m)
    pool = (np.arange(pool_size) * (n / pool_size)).astype(np.int64)
    sub_sel = fps_host(coords[pool], m)
    return pool[sub_sel]
