"""Build and load the port's CUDA kernels.

Each ``raycore_tpu_torch/csrc/*.cu`` is compiled to an object by its own
``nvcc`` process, all started together, and one more ``nvcc`` links them
into ``raycore_tpu_torch/_build/libraycore_kernels.so``, a shared library
with a plain C interface loaded with ``ctypes``. The build runs at first
use and is cached by a hash of the sources and flags, so the first kernel
launch in a fresh checkout builds everything. Each entry point launches on
the stream it is given and returns ``cudaGetLastError()``; ``check``
raises on a non-zero code.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
then ``PATH``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libraycore_kernels.so"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Entry point -> argtypes. Every entry point returns an int error code.
_SIGNATURES = {
    "raycore_phase_a": (_P, _P, _P, _I, _I, _F, _P),
    "raycore_empty_launch": (_I, _I, _I, _P),
    "raycore_refine_pairs": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    "raycore_instance_refresh": (_P, _P, _P, _P, _P, _P, _I, _P),
    "raycore_local_rays": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _P),
    "raycore_regroup_sweep": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _F, _F, _P),
    "raycore_worklist_sweep": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _F, _F, _F, _P),
    "raycore_occlusion_sweep": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _F, _F, _P),
    "raycore_packed_sweep": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _F, _P),
    "raycore_brute_sweep": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "raycore_gather_probe": (_P, _P, _P, _I, _I, _I, _I, _P),
    "raycore_epilogue_probe": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                               _F, _P),
    "raycore_epilogue_rcp_check": (_I, _P, _P),
    "raycore_matmul_probe": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "raycore_block_probe": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                            _P),
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH: "
        "the CUDA toolkit is needed to build the port's kernels")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels unless the cached library matches the sources.
    Returns the library's path."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib_path.is_file() and stamp.is_file() \
            and stamp.read_text().strip() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [f"{tmp}/{p.stem}.o" for p in sources()]
        _nvcc_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                   for p, o in zip(sources(), objs)])
        _nvcc_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}/{LIB_NAME}",
                    *objs]])
        os.replace(f"{tmp}/{LIB_NAME}", lib_path)
        Path(tmp, "stamp").write_text(digest + "\n")
        os.replace(f"{tmp}/stamp", stamp)
    return lib_path


def _nvcc_all(cmds) -> None:
    """Run the commands at once; raise with the output of the first that
    fails once all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed (nvcc exit "
                               f"{p.returncode}): {' '.join(p.args)}\n{out}")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.raycore_error_string.argtypes = (ctypes.c_int,)
            lib.raycore_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().raycore_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    """Handle of PyTorch's current stream on the device of tensor ``t``."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, dtype, name: str, device=None) -> None:
    """Check that a kernel input is a contiguous CUDA tensor of ``dtype``
    (on ``device`` when given), 16-byte aligned."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")
