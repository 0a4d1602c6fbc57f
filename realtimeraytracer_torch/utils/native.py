"""ctypes bindings for the native host library (native/*.cpp).

Counterpart of realtimeraytracer_tpu/utils/native.py (``load_library``,
``native_build_bvh``, ``NativeObj``): the reference's native scene IO and
acceleration-structure builds (tinyobjloader, Vulkan's AS builds) as a
C ABI library, the binned-SAH and Morton LBVH builders and the OBJ
tokenizer.  The scene compile builds its BVHs here first, so its block
order is the JAX compile's.

The library is built at first use from the sources in ``native/`` (read,
never written) with the compiler and flags that ``native/Makefile`` names
(``$CXX``, default g++; ``-O3 -fPIC -std=c++17 -Wall -march=native
-shared``), so it is byte-identical to the Makefile's on the same machine
and its trees equal the JAX package's leaf for leaf.  It goes into the
kernels' build directory (``kernels.BUILD_DIR``), under a name that hashes
the sources, the flags, the compiler's ``--version`` and the host CPU's
feature flags (``-march=native`` code must not load on another CPU).  A
file lock keeps concurrent processes to one build.

Only a machine without a C++ compiler falls back, with a logged warning,
to the NumPy builders (``native_build_bvh`` returns None, as JAX's does
without a toolchain); a compiler whose build or load fails raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shlex
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from realtimeraytracer_torch.kernels import BUILD_DIR
from realtimeraytracer_torch.utils import log

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("objparse.cpp", "bvh_build.cpp", "bvh_sah.cpp")
# native/Makefile's CXXFLAGS, then its link flag, in its order.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def _compiler() -> list[str] | None:
    """The compiler command (``$CXX`` or g++), or None if it is not on the
    machine."""
    cmd = shlex.split(os.environ.get("CXX") or "g++")
    return cmd if cmd and shutil.which(cmd[0]) else None


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine() + " " + platform.processor()


def library_path(cxx: list[str]) -> Path:
    """Where the library built by `cxx` goes: its name hashes the sources,
    the flags, the compiler's version and the CPU's feature flags."""
    version = subprocess.run([*cxx, "--version"], capture_output=True, text=True)
    if version.returncode != 0:
        raise RuntimeError(f"{' '.join(cxx)} --version failed:\n{version.stderr}")
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + (NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(version.stdout.encode())
    h.update(_cpu_flags().encode())
    return BUILD_DIR / f"librtrt_native-{h.hexdigest()[:16]}.so"


def build(cxx: list[str]) -> Path:
    """Compile the native sources with `cxx` unless a library of the same
    hash exists; raises with the compiler's stderr if the build fails."""
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "librtrt_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():       # built by another process while this one waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        # From native/, with its file names, as `make -C native` runs.
        proc = subprocess.run([*cxx, *CXX_FLAGS, "-o", str(tmp), *SOURCES],
                              cwd=NATIVE_DIR, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the native library with {' '.join(cxx)} failed:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    log.debug("native library built: {}", out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.obj_parse_file.restype = c.c_void_p
    lib.obj_parse_file.argtypes = [c.c_char_p]
    lib.obj_free.argtypes = [c.c_void_p]
    for name in ("obj_num_positions", "obj_num_texcoords", "obj_num_normals",
                 "obj_num_tris", "obj_num_shapes", "obj_num_mtllibs"):
        getattr(lib, name).restype = c.c_int64
        getattr(lib, name).argtypes = [c.c_void_p]
    for name, ty in (("obj_positions", c.c_float), ("obj_texcoords", c.c_float),
                     ("obj_normals", c.c_float), ("obj_corners", c.c_int64),
                     ("obj_tri_shapes", c.c_int32)):
        getattr(lib, name).restype = c.POINTER(ty)
        getattr(lib, name).argtypes = [c.c_void_p]
    for name in ("obj_shape_name", "obj_shape_material", "obj_mtllib"):
        getattr(lib, name).restype = c.c_char_p
        getattr(lib, name).argtypes = [c.c_void_p, c.c_int64]
    lib.bvh_num_nodes.restype = c.c_int64
    lib.bvh_num_nodes.argtypes = [c.c_int64, c.c_int64]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bvh_build.restype = c.c_int64
    lib.bvh_build.argtypes = [f32p, f32p, f32p, c.c_int64, c.c_int64,
                              f32p, f32p, i32p, i32p, i32p, i32p]
    lib.bvh_build_sah.restype = c.c_int64
    lib.bvh_build_sah.argtypes = [f32p, f32p, f32p, c.c_int64, c.c_int64,
                                  c.c_int64, f32p, f32p, i32p, i32p, i32p, i32p]
    return lib


def load_library():
    """The native library, built on first use; None only on a machine
    without a C++ compiler (a warning is logged once)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        cxx = _compiler()
        if cxx is None:
            _tried = True
            log.warn("no C++ compiler ({}) on this machine: the scene compile uses the NumPy "
                     "BVH builder and the OBJ loader its Python tokenizer",
                     os.environ.get("CXX") or "g++")
            return None
        path = build(cxx)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load the native library {path}: {e}") from e
        _lib = _bind(lib)
        _tried = True
        log.debug("native library loaded: {}", path)
        return _lib


def native_build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     leaf_size: int = 4, builder: str = "sah"):
    """Native BVH build (binned SAH; any other `builder` the Morton LBVH,
    the NumPy ``build_bvh``'s order); returns ops.bvh.BVHArrays, or None
    without a C++ compiler."""
    lib = load_library()
    if lib is None:
        return None
    from realtimeraytracer_torch.ops.bvh import BVHArrays

    t = len(v0)
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    order = np.empty(t, np.int32)
    n = 2 * t + 1 if builder == "sah" else lib.bvh_num_nodes(t, leaf_size)
    node_min = np.empty((n, 3), np.float32)
    node_max = np.empty((n, 3), np.float32)
    node_skip = np.empty(n, np.int32)
    node_first = np.empty(n, np.int32)
    node_count = np.empty(n, np.int32)
    flat = (v0.reshape(-1), v1.reshape(-1), v2.reshape(-1), t, leaf_size)
    nodes = (node_min.reshape(-1), node_max.reshape(-1), node_skip, node_first, node_count, order)
    if builder == "sah":
        written = lib.bvh_build_sah(*flat, n, *nodes)
        if written <= 0:
            raise RuntimeError(f"native SAH build failed on {t} triangles")
    else:
        written = lib.bvh_build(*flat, *nodes)
        if written != n:
            raise RuntimeError(f"native LBVH build wrote {written} of {n} nodes")
    return BVHArrays(node_min=node_min[:written].copy(), node_max=node_max[:written].copy(),
                     node_skip=node_skip[:written].copy(), node_first=node_first[:written].copy(),
                     node_count=node_count[:written].copy(),
                     tri_v0=v0[order], tri_v1=v1[order], tri_v2=v2[order], tri_id=order)


class NativeObj:
    """Parsed OBJ handle (RAII wrapper over the C++ tokenizer)."""

    def __init__(self, path: str):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library not available")
        self._lib = lib
        self._h = lib.obj_parse_file(str(path).encode())
        if not self._h:
            raise FileNotFoundError(path)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.obj_free(self._h)
            self._h = None

    def arrays(self):
        """(positions, texcoords, normals, corners (T, 3, 3) i64, tri_shape,
        [(shape name, material)], mtllibs)."""
        lib, h = self._lib, self._h

        def np_from(ptr, n, dt):
            # n == 0: the C++ vector's data() may be NULL, which as_array
            # refuses (an OBJ with no vt or vn).
            if n == 0:
                return np.empty((0,), dt)
            return np.ctypeslib.as_array(ptr(h), shape=(n,)).astype(dt, copy=True)

        ntri = lib.obj_num_tris(h)
        positions = np_from(lib.obj_positions, lib.obj_num_positions(h) * 3, np.float32)
        texcoords = np_from(lib.obj_texcoords, lib.obj_num_texcoords(h) * 2, np.float32)
        normals = np_from(lib.obj_normals, lib.obj_num_normals(h) * 3, np.float32)
        corners = np_from(lib.obj_corners, ntri * 9, np.int64).reshape(-1, 3, 3)
        tri_shape = np_from(lib.obj_tri_shapes, ntri, np.int32)
        shapes = [(lib.obj_shape_name(h, i).decode(errors="replace"),
                   lib.obj_shape_material(h, i).decode(errors="replace"))
                  for i in range(lib.obj_num_shapes(h))]
        mtllibs = [lib.obj_mtllib(h, i).decode(errors="replace")
                   for i in range(lib.obj_num_mtllibs(h))]
        return (positions.reshape(-1, 3), texcoords.reshape(-1, 2), normals.reshape(-1, 3),
                corners, tri_shape, shapes, mtllibs)
