"""Build and load the port's CUDA kernels; count kernel launches.

`csrc/*.cu` are compiled by `nvcc` into one shared library with a plain C
interface, at first use, under `build/ecamp_tpu_torch/` in the checkout
(listed in `.gitignore`): one `nvcc -c` per source, all started together,
then one link. The library's name carries a hash of the
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ecamp_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the launch wrappers in csrc/: pointers and the stream are
# c_void_p (ctypes would pass a bare Python int as a 32-bit int)
SIGNATURES = {
    "ecamp_attention_fwd": [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _P,
                            _I, _I, _I, _I, _I, _I, _F, _P],
    "ecamp_layer_norm_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "ecamp_sr_conv_stack_fwd": [_P, _P, _P, _I, _I, _I, _I, _P],
    "ecamp_sr_conv_stack_fwd_tma": [_P, _P, _P, _I, _I, _I, _I, _P],
    "ecamp_adamw_multi": [_P, _P, _P, _P, _P, _I, _P, _LL, _F, _F, _F, _F,
                          _F, _P],
    "ecamp_fused_ce_fwd": [_P] * 6 + [_I] * 4 + [_P],
    "ecamp_fused_ce_fwd_tiles": [_P] * 6 + [_I] * 4 + [_P],
    "ecamp_fused_ce_fwd_merge": [_P] * 4 + [_I] * 3 + [_P],
    "ecamp_fused_ce_bwd_dx": [_P] * 7 + [_I] * 4 + [_P],
    "ecamp_fused_ce_bwd_dw": [_P] * 8 + [_I] * 4 + [_P],
    "ecamp_fused_ce_bwd_dl": [_P] * 8 + [_I] * 6 + [_P],
    "ecamp_fused_ce_bwd_dx_chunk": [_P] * 4 + [_I] * 8 + [_P],
    "ecamp_fused_ce_bwd_dw_chunk": [_P] * 5 + [_I] * 6 + [_P],
    "ecamp_wgmma_gemm": [_P] * 3 + [_I] * 4 + [_P],
    "ecamp_int8_linear": [_P] * 5 + [_I] * 3 + [_P],
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

    Each source compiles in its own `nvcc -c`, all at once; the objects
    are then linked. The compilers' output (ptxas registers, shared memory
    and spills per kernel) is kept next to the library as `<lib>.log`."""
    lib = BUILD_DIR / f"libecamp_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    tmp = lib.with_suffix(f".{tag}.tmp")
    link = [nvcc, *NVCC_FLAGS[:4], "-shared", "-o", str(tmp),
            *map(str, objs)]
    failed = [(cmd, proc.returncode) for cmd, proc in zip(cmds, procs)
              if proc.returncode != 0]
    if not failed:
        done = subprocess.run(link, capture_output=True, text=True)
        outs.append(done.stdout + done.stderr)
        if done.returncode != 0:
            failed.append((link, done.returncode))
    log = "".join(" ".join(cmd) + "\n" + out
                  for cmd, out in zip(cmds + [link], outs))
    lib.with_suffix(".log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0][1]}): "
                           f"{' '.join(failed[0][0])}\n{log}")
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


def launch_stream(t) -> int:
    """The raw handle of the current CUDA stream of t's device, which the
    caller has made the current device: where PyTorch's own work there
    goes, so a kernel launched on it needs no synchronisation. The private
    call is the one torch's compiled kernels launch with;
    `torch.cuda.current_stream().cuda_stream` gives the same handle at
    several times the host cost, which a short kernel launched 51 times a
    step pays each time."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_current_device(t) -> bool:
    """Whether t lies on the current CUDA device (a wrapper switches to its
    tensors' device only when it does not)."""
    return t.get_device() == torch.cuda.current_device()


def needs_grad(*tensors) -> bool:
    """Whether autograd has to see a kernel's call: a wrapper that does not
    goes straight to its launch and skips the `autograd.Function`'s host
    cost (inference, the serving path)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a launch wrapper."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
