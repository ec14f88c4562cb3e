"""Wavefront OBJ loading (counterpart of ``raycore_tpu/scene/obj.py``):
the repository's native C++ parser (``native/objloader.cpp``) bound with
ctypes, and a Python parser of the same subset (``v``/``vn``/``f`` with
fan triangulation and relative indices).

``load_obj(native=True)`` builds the native parser with ``g++`` into
``raycore_tpu_torch/_build/libobjloader.so`` at first use (cached by a
hash of the source) and raises when it cannot be built or loaded;
``native=None`` or ``False`` takes the Python parser. The JAX package's
``native=None`` tries the native parser first and falls back; here no
failure chooses a path, so the caller names the parser.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..core.triangle import Triangle
from .mesh import build_triangles

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "objloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libobjloader.so"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _build_native() -> Path:
    """Compile the parser unless the cached library matches the source."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(NATIVE_SRC.read_bytes())
    digest = h.hexdigest()
    if lib_path.is_file() and stamp.is_file() \
            and stamp.read_text().strip() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = subprocess.run(["g++", *GXX_FLAGS, "-o", f"{tmp}/{LIB_NAME}",
                              str(NATIVE_SRC)], capture_output=True,
                             text=True)
        if out.returncode != 0:
            raise RuntimeError(f"native OBJ parser build failed (g++ exit "
                               f"{out.returncode}):\n{out.stderr}")
        os.replace(f"{tmp}/{LIB_NAME}", lib_path)
        Path(tmp, "stamp").write_text(digest + "\n")
        os.replace(f"{tmp}/stamp", stamp)
    return lib_path


def native_library() -> ctypes.CDLL:
    """The loaded native parser, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build_native()))
            lib.obj_count.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_long),
                                      ctypes.POINTER(ctypes.c_long)]
            lib.obj_count.restype = ctypes.c_int
            lib.obj_parse.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_float)]
            lib.obj_parse.restype = ctypes.c_int
            _lib = lib
    return _lib


def _parse_obj_native(path: str):
    """(vertices (V, 3) float32, faces (F, 3) int32, per-vertex normals or
    None) by the native parser."""
    lib = native_library()
    nv, nf = ctypes.c_long(), ctypes.c_long()
    if lib.obj_count(path.encode(), ctypes.byref(nv), ctypes.byref(nf)) != 0:
        raise FileNotFoundError(path)
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    normals = np.empty((nv.value, 3), np.float32)
    rc = lib.obj_parse(
        path.encode(),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        normals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"obj_parse failed with code {rc}")
    return verts, faces, (normals if normals.any() else None)


def _parse_obj_python(path: str):
    """The same triple by the Python parser (faces int64)."""
    verts, normals, faces = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(2, len(idx)):
                    faces.append([idx[0], idx[k - 1], idx[k]])
    v = np.asarray(verts, np.float32)
    n = np.asarray(normals, np.float32) if len(normals) == len(verts) \
        else None
    return v, np.asarray(faces, np.int64), n


def load_obj(path: str, metadata=None, native: bool | None = None,
             device=None) -> Triangle:
    """Load an OBJ file into a Triangle SoA on ``device`` (the CUDA card by
    default): the native parser with ``native=True``, else the Python
    parser. ``metadata`` as in ``build_triangles``."""
    parse = _parse_obj_native if native is True else _parse_obj_python
    verts, faces, normals = parse(path)
    return build_triangles(verts, faces, normals=normals, metadata=metadata,
                           device=device)
