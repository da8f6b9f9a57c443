"""Build and load the port's CUDA kernels; count kernel launches.

`csrc/*.cu` are compiled by `nvcc` into one shared library with a plain C
interface, at first use, under `build/ecamp_tpu_torch/` in the checkout
(listed in `.gitignore`). The library's name carries a hash of the
sources and flags, so an edit rebuilds and a stale library is never
loaded. It is bound with `ctypes`, so PyTorch's headers, which make a
CUDA build several times longer, stay out of it.

Every C launch wrapper returns `cudaGetLastError()` after its launch; a
non-zero value raises here. A refused launch (too many threads, too much
shared memory) would otherwise never run and never be reported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ecamp_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of the launch wrappers in csrc/: pointers and the stream are
# c_void_p (ctypes would pass a bare Python int as a 32-bit int)
SIGNATURES = {
    "ecamp_attention_fwd": [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _P,
                            _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
}


class LaunchCounter:
    """Kernel launches since the last `reset()`; one per wrapper.

    A wrapper adds one where it launches its kernel and nowhere else, so a
    run can show that its main path went through the kernel."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is built already.

    The compiler's output (ptxas registers, shared memory and spills per
    kernel) is kept next to the library as `<lib>.log`."""
    lib = BUILD_DIR / f"libecamp_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build loads a whole file
    return lib


_LOAD_LOCK = threading.Lock()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    with _LOAD_LOCK:
        return _load()


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a launch wrapper."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
