"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

The sources compile with ``nvcc`` (one process per source, all started
together) and link into one shared library with a plain C interface,
bound with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
library is built at first use into ``build/p2p_bridge_tpu_torch/<hash>/``
at the repository root, keyed by a hash of the sources and the flags, so
an edited source rebuilds. A failed build raises.

Every op wrapper checks its tensors with one call of :func:`check` and
then calls :func:`launch`, which passes the card's index and the raw handle
of PyTorch's current stream on that card to the C entry point (the entry
makes the card current only when it is not), raises on a non-zero
``cudaGetLastError()``, and adds one to the kernel's count in
:data:`launch_counts`. The entry points are looked up once
(:func:`entry_points`); no ``torch.cuda.device`` context or ``Stream``
object is built per call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fps.cu", "ball_query_group.cu", "voxelize.cu", "conv3d_gn.cu",
           "devoxelize.cu", "interpolate.cu", "auction.cu", "scatter_rows.cu")
HEADERS = ("common.cuh", "hopper.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "p2p_bridge_tpu_torch"

# kernel name -> number of launches since the last reset
launch_counts = {"fps": 0, "fps_cluster": 0, "ball_query_group": 0, "avg_voxelize": 0,
                 "conv3d_gn": 0, "trilinear_devoxelize": 0, "three_nn_interpolate": 0,
                 "avg_voxelize_backward": 0, "auction_emd": 0, "scatter_rows": 0}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # name: (restype, argtypes); every launching entry ends with the card's
    # index and the stream, which launch() appends
    "p2pb_fps": (_I, (_P, _I, _I, _I, _P, _P, _I, _P)),
    "p2pb_fps_scratch_bytes": (_LL, (_I, _I)),
    "p2pb_fps_cluster": (_I, (_P, _I, _I, _I, _P, _P, _I, _P)),
    "p2pb_fps_cluster_scratch_bytes": (_LL, (_I, _I)),
    "p2pb_ball_query_group": (_I, (_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P, _I, _P)),
    "p2pb_avg_voxelize": (_I, (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P)),
    "p2pb_avg_voxelize_backward": (_I, (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P)),
    "p2pb_auction_emd": (_I, (_P, _I, _I, _I, _F, _I, _P, _P, _P, _I, _P)),
    "p2pb_auction_smem_bytes": (_LL, (_I, _I)),
    "p2pb_conv3d_gn": (
        _I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P, _I, _P)),
    "p2pb_conv3d_gn_scratch_bytes": (_LL, (_I, _I, _I, _I, _I)),
    "p2pb_trilinear_devoxelize": (_I, (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P)),
    "p2pb_devoxelize_scratch_bytes": (_LL, (_I, _I, _I)),
    "p2pb_three_nn_interpolate": (_I, (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P)),
    "p2pb_scatter_rows": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P)),
    "p2pb_error_string": (ctypes.c_char_p, (_I,)),
}
DATA = (torch.float32, torch.bfloat16)  # the element types of a kernel's data


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libp2pb_kernels.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, src + ".o") for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        failed = []
        for src, proc in zip(SOURCES, procs):
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{src} ({proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent build sees whole files only
    return out


@functools.lru_cache(maxsize=None)
def entry_points() -> dict:
    """The library's C entry points by name, each with its signature set;
    built and looked up once per process."""
    lib = ctypes.CDLL(str(build()))
    out = {}
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
        out[name] = fn
    return out


def current_stream(device: int) -> int:
    """The raw handle of PyTorch's current stream on card ``device``."""
    return torch._C._cuda_getCurrentRawStream(device)


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"tensors must lie on a CUDA card or the CPU, not {t.device}")
    return False


def check(*specs) -> int:
    """The one check of the tensors a kernel takes. Each spec is (name,
    tensor, dtype, shape): dtype a torch.dtype or a tuple of them (DATA),
    shape a tuple of sizes. Raises unless every tensor lies on the device of
    the first and is a contiguous tensor of its dtype and shape; returns that
    device's index."""
    first = specs[0][1]
    device = first.device
    for name, t, dtype, shape in specs:
        if (t.device != device or t.shape != shape or not t.is_contiguous()
                or (t.dtype not in dtype if type(dtype) is tuple else t.dtype != dtype)):
            _reject(name, t, dtype, shape, device)
    return first.get_device()


def _reject(name, t, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.dtype not in (dtype if type(dtype) is tuple else (dtype,)):
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    raise ValueError(f"{name}: must be contiguous")


def launch(kernel: str, entry: str, device: int, *args) -> None:
    """Run C entry point ``entry`` on card ``device`` and PyTorch's current
    stream there; raise on a CUDA error; count one launch of ``kernel``."""
    fns = entry_points()
    err = fns[entry](*args, device, current_stream(device))
    if err != 0:
        msg = fns["p2pb_error_string"](err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
    launch_counts[kernel] += 1
