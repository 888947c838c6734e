"""Build, load and count the hand-written Hopper kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``.  Libraries are built at first use,
all sources in parallel, into ``build/kernels/`` at the root of the
checkout, and named by a hash of their source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source is rebuilt and an unchanged
one is reused.  ``defines`` builds a variant of a library beside it (the
phase-clock build of ``phase_clocks.py``).

``LAUNCHES`` counts kernel launches by kernel name; a wrapper adds one
(``LAUNCHES.add(name)``) exactly where it launches its kernel, never on
the plain path.  ``TRANSFORM_LAUNCHES`` counts the same launches of the
integer encode (kernel 2) by its word transform, as
``encode_ints_fused_<transform>``.  Both are ``obs.CounterView``s with
locked increments, so a service's worker thread and a client thread
launching at once lose no count; their families live in a registry of
their own (``LAUNCH_REGISTRY``), so the process registry's exposition
holds the reference's families alone.  Readers keep the ``Counter``
idioms (``[]``, ``dict()``, ``.values()``, ``.clear()``).

``library_loads()`` counts the libraries built or loaded: the port's
only first-use cost, read by ``engine.device.trace_count``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..obs.registry import CounterView, MetricsRegistry

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("subbin_sweep", "fused_encode", "fused_decode", "bitshuffle", "rze",
           "ff32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCH_REGISTRY = MetricsRegistry()
LAUNCHES: CounterView = CounterView(LAUNCH_REGISTRY.counter(
    "lopc_kernel_launches_total", "hand-written kernel launches by kernel"))
TRANSFORM_LAUNCHES: CounterView = CounterView(LAUNCH_REGISTRY.counter(
    "lopc_kernel_transform_launches_total",
    "integer encode launches by word transform"))

_LOCK = threading.Lock()
_LIBS: dict[tuple[str, tuple], ctypes.CDLL] = {}
_FNS: dict[tuple[str, str, tuple], ctypes._CFuncPtr] = {}
_LOADS = 0


def reset_launches() -> None:
    LAUNCHES.clear()
    TRANSFORM_LAUNCHES.clear()


def library_loads() -> int:
    """Libraries built or loaded so far (misses of :func:`library`)."""
    return _LOADS


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _flags(defines: tuple = ()) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def _lib_path(name: str, defines: tuple = ()) -> Path:
    # the shared headers are part of every source's build
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    flags = " ".join(_flags(defines)).encode()
    digest = hashlib.sha256(src + flags).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names=SOURCES, defines: tuple = ()) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns the wall seconds spent; raises on any failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _lib_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    global _LOADS
    with _LOCK:
        lib = _LIBS.get((name, defines))
        if lib is None:
            build(SOURCES if not defines else (name,), defines)
            lib = ctypes.CDLL(str(_lib_path(name, defines)))
            lib.lopc_errstr.restype = ctypes.c_char_p
            lib.lopc_errstr.argtypes = [ctypes.c_int]
            _LIBS[(name, defines)] = lib
            _LOADS += 1
        return lib


def _ctype(a):
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p
    return ctypes.c_double if isinstance(a, float) else ctypes.c_longlong


def call(name: str, fn: str, *args, defines: tuple = ()) -> None:
    """Call ``fn`` of library ``name`` with pointers, ints and the current
    stream appended; raise with CUDA's message on a nonzero return.  The
    C signature is read off the first call's arguments and kept."""
    f = _FNS.get((name, fn, defines))
    if f is None:
        f = getattr(library(name, defines), fn)
        f.argtypes = [_ctype(a) for a in args] + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FNS[(name, fn, defines)] = f
    argv = [a.data_ptr() if isinstance(a, torch.Tensor)
            else a if isinstance(a, float) else int(a) for a in args]
    err = f(*argv, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"{fn} failed: {library(name, defines).lopc_errstr(err).decode()} "
            f"(cudaError {err})")


def require_cuda(*tensors: torch.Tensor) -> None:
    """Check that every tensor lies on one CUDA device and is contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError("kernel operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
