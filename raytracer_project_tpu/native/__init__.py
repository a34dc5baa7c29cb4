"""ctypes bindings for the zenith_native C++ runtime (csrc/zenith_native.cpp).

The native library owns the host-side heavy lifting (SAH BVH builds, OBJ
parsing, PNG export) — the roles the reference engine's C++ does outside the
per-ray hot loop. It is compiled on first use from csrc/ with the system
toolchain into build/ inside the checkout; every entry point has a
pure-Python fallback, so the framework works (slower) without a compiler.

Set RAYTRACER_TPU_NO_NATIVE=1 to force the Python fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc",
                    "zenith_native.cpp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


class _ZnBvh(ctypes.Structure):
    _fields_ = [
        ("node_min", ctypes.POINTER(ctypes.c_float)),
        ("node_max", ctypes.POINTER(ctypes.c_float)),
        ("escape", ctypes.POINTER(ctypes.c_int32)),
        ("first", ctypes.POINTER(ctypes.c_int32)),
        ("count", ctypes.POINTER(ctypes.c_int32)),
        ("level", ctypes.POINTER(ctypes.c_int32)),
        ("leaf_order", ctypes.POINTER(ctypes.c_int64)),
        ("n_nodes", ctypes.c_int32),
        ("n_prims", ctypes.c_int64),
        ("n_levels", ctypes.c_int32),
        ("max_leaf", ctypes.c_int32),
    ]


class _ZnMesh(ctypes.Structure):
    _fields_ = [
        ("v0", ctypes.POINTER(ctypes.c_double)),
        ("v1", ctypes.POINTER(ctypes.c_double)),
        ("v2", ctypes.POINTER(ctypes.c_double)),
        ("n0", ctypes.POINTER(ctypes.c_double)),
        ("n1", ctypes.POINTER(ctypes.c_double)),
        ("n2", ctypes.POINTER(ctypes.c_double)),
        ("count", ctypes.c_int64),
        ("has_normals", ctypes.c_int32),
    ]


def _build_dir() -> str:
    """build/ inside the checkout (listed in .gitignore)."""
    from .. import CHECKOUT_DIR

    d = os.path.join(CHECKOUT_DIR, "build")
    os.makedirs(d, exist_ok=True)
    return d


def _compile(src: str, out: str) -> bool:
    cmd = ["g++", "-O3", "-std=c++20", "-shared", "-fPIC", "-march=native",
           src, "-o", out]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return res.returncode == 0 and os.path.exists(out)


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("RAYTRACER_TPU_NO_NATIVE"):
            return None
        src = os.path.abspath(_SRC)
        if not os.path.exists(src):
            return None
        lib_path = os.path.join(_build_dir(), "libzenith_native.so")
        # Rebuild when the source is newer than the cached library.
        if (not os.path.exists(lib_path)
                or os.path.getmtime(lib_path) < os.path.getmtime(src)):
            tmp = lib_path + f".tmp{os.getpid()}"
            if not _compile(src, tmp):
                return None
            os.replace(tmp, lib_path)
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None
        lib.zn_bvh_build.restype = ctypes.POINTER(_ZnBvh)
        lib.zn_bvh_build.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ]
        lib.zn_bvh_free.argtypes = [ctypes.POINTER(_ZnBvh)]
        lib.zn_obj_parse.restype = ctypes.POINTER(_ZnMesh)
        lib.zn_obj_parse.argtypes = [ctypes.c_char_p]
        lib.zn_mesh_free.argtypes = [ctypes.POINTER(_ZnMesh)]
        lib.zn_png_write.restype = ctypes.c_int32
        lib.zn_png_write.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.zn_version.restype = ctypes.c_char_p
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _as_np(ptr, shape, dtype):
    arr = np.ctypeslib.as_array(ptr, shape=shape)
    return np.array(arr, dtype=dtype)  # copy out of the C buffer


def build_bvh(pmin: np.ndarray, pmax: np.ndarray, leaf_size: int,
              bins: int = 16) -> dict | None:
    """Native binned-SAH flat threaded BVH; None if the library is absent.

    Returns dict(node_min, node_max, escape, first, count, level,
    leaf_order, n_levels, max_leaf) in the ops/bvh.py _flatten contract.
    """
    lib = _load()
    if lib is None:
        return None
    pmin = np.ascontiguousarray(pmin, np.float32)
    pmax = np.ascontiguousarray(pmax, np.float32)
    n = pmin.shape[0]
    res = lib.zn_bvh_build(
        n,
        pmin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pmax.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(leaf_size), int(bins),
    )
    if not res:
        return None
    try:
        c = res.contents
        nn = int(c.n_nodes)
        out = dict(
            node_min=_as_np(c.node_min, (nn, 3), np.float32),
            node_max=_as_np(c.node_max, (nn, 3), np.float32),
            escape=_as_np(c.escape, (nn,), np.int32),
            first=_as_np(c.first, (nn,), np.int32),
            count=_as_np(c.count, (nn,), np.int32),
            level=_as_np(c.level, (nn,), np.int32),
            leaf_order=_as_np(c.leaf_order, (n,), np.int64),
            n_levels=int(c.n_levels),
            max_leaf=int(c.max_leaf),
        )
    finally:
        lib.zn_bvh_free(res)
    return out


def parse_obj(path: str) -> dict | None:
    """Native OBJ parse; None if unavailable or the file can't be read."""
    lib = _load()
    if lib is None:
        return None
    res = lib.zn_obj_parse(os.fsencode(path))
    if not res:
        return None
    try:
        c = res.contents
        t = int(c.count)
        if t == 0:
            return dict(v0=np.zeros((0, 3)), v1=np.zeros((0, 3)),
                        v2=np.zeros((0, 3)), n0=None, n1=None, n2=None)
        out = dict(
            v0=_as_np(c.v0, (t, 3), np.float64),
            v1=_as_np(c.v1, (t, 3), np.float64),
            v2=_as_np(c.v2, (t, 3), np.float64),
        )
        if c.has_normals:
            out.update(
                n0=_as_np(c.n0, (t, 3), np.float64),
                n1=_as_np(c.n1, (t, 3), np.float64),
                n2=_as_np(c.n2, (t, 3), np.float64),
            )
        else:
            out.update(n0=None, n1=None, n2=None)
    finally:
        lib.zn_mesh_free(res)
    return out


def write_png(path: str, rgb_u8: np.ndarray) -> bool:
    """Native PNG write; False if unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w = arr.shape[:2]
    rc = lib.zn_png_write(
        os.fsencode(path), w, h,
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return rc == 0
