"""Build and load the port's hand-written CUDA kernels.

No JAX counterpart: the JAX package's Pallas kernels are compiled by XLA.
Here each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, at
first use, under ``build/kernels/`` beside the package (in a checkout, the
repository's ``build/kernels/``).  Set ``RT_TORCH_KERNEL_DIR`` to build
elsewhere, e.g. when the package is installed into a read-only or shared
``site-packages``.  A library's file name carries a hash of its source,
every header under ``csrc/`` (``*.cuh``, which sources include) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.
Libraries load with ``ctypes``; every pointer and the CUDA stream are
passed as ``c_void_p``.

Nothing here runs at import: the tests import every module on machines
without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(os.environ.get("RT_TORCH_KERNEL_DIR")
                 or Path(__file__).resolve().parent.parent / "build" / "kernels")

# -fmad=false: no a*b+c contraction, so each kernel rounds as its plain
# PyTorch twin does (see the notes in the sources).  Never fast-math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# entry name -> (source name, entry symbol, argtypes); each entry returns a
# cudaError_t, and its source has a companion `rt_<source>_error(int) ->
# const char*`.
SIGNATURES = {
    "trace_v7": ("trace_v7", "rt_trace_v7", [_P] * 7 + [_I] * 5 + [_P]),
    "trace_v8": ("trace_v8", "rt_trace_v8", [_P] * 8 + [_I] * 8 + [_P]),
    "trace_v8_inst": ("trace_v8", "rt_trace_v8_inst", [_P] * 9 + [_I] * 8 + [_P]),
    "trace_v8_multi": ("trace_v8", "rt_trace_v8_multi", [_P] * 6 + [_I] * 6 + [_P]),
    "trace_v9": ("trace_v9", "rt_trace_v9", [_P] * 8 + [_I] * 4 + [_P]),
    "atrous_pair": ("atrous_pair", "rt_atrous_pair", [_P] * 7 + [_I] * 3 + [_F] * 4 + [_P]),
    "atrous_pair_vjp": ("atrous_pair_vjp", "rt_atrous_pair_vjp",
                        [_P] * 13 + [_I] * 3 + [_F] * 4 + [_P]),
    "fma_peak": ("fma_peak", "rt_fma_peak", [_P] * 2 + [_I] * 2 + [_P]),
}
SOURCES = tuple(dict.fromkeys(src for src, _, _ in SIGNATURES.values()))

_lock = threading.Lock()
_loaded: dict[str, tuple] = {}
# nvcc's stderr of each build made in this process (ptxas register and
# shared-memory report), by source name.
build_log: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and in {cuda_home}/bin): the "
            "CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library goes: its name carries a hash of the
    source, the headers under csrc/ and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same hash exists."""
    src = CSRC / f"{name}.cu"
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    build_log[name] = proc.stderr
    os.replace(tmp, out)
    return out


def kernel(name: str):
    """The ctypes entry `name` of SIGNATURES, building its source on first
    use."""
    with _lock:
        entry = _loaded.get(name)
        if entry is None:
            source, symbol, argtypes = SIGNATURES[name]
            lib = ctypes.CDLL(str(build(source)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"rt_{source}_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            entry = _loaded[name] = (fn, err)
    return entry


def launch(name: str, *args) -> None:
    """Call a kernel's C entry and raise if its launch reported an error."""
    fn, err_string = kernel(name)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: error {err} "
            f"({err_string(err).decode()})")


def build_all() -> dict[str, Path]:
    """Build (or find) every kernel library, one nvcc per source, all
    started together; returns name -> path."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}
