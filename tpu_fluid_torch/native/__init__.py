"""The native C++ rasterizer (`tpu_fluid.native`), loaded with ctypes.

`rasterizer.cpp` is a copy of the JAX package's source.  The shared
library builds with g++ into `build/tpu_fluid_torch/` beside the package
(the CUDA kernels' directory), at first use and again whenever the source
is newer.  A failed build raises with g++'s output: nothing falls back to
another renderer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

from tpu_fluid_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "rasterizer.cpp"
LIBRARY = BUILD_DIR / "librasterizer.so"

_cached = None


def build_library(force: bool = False) -> Path:
    """Compile rasterizer.cpp -> librasterizer.so (mtime-cached); raise
    RuntimeError with the compiler's output if it fails."""
    if (not force and LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the library and rename, so a concurrent loader never
    # maps half a file
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("native rasterizer: g++ not found") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native rasterizer: g++ failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    tmp.replace(LIBRARY)
    return LIBRARY


def load_rasterizer():
    """ctypes handle with argtypes configured (built on first use)."""
    global _cached
    if _cached is not None:
        return _cached
    lib = ctypes.CDLL(str(build_library()))
    c_fp = ctypes.POINTER(ctypes.c_float)
    c_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.rasterize_triangles.argtypes = [
        c_fp, c_fp, ctypes.c_long, c_fp, ctypes.c_int, ctypes.c_int,
        c_fp, c_u8]
    lib.rasterize_points.argtypes = [
        c_fp, c_u8, ctypes.c_long, c_fp, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, c_fp, c_u8]
    lib.clear_buffers.argtypes = [
        c_fp, c_u8, ctypes.c_long,
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8]
    for fn in (lib.rasterize_triangles, lib.rasterize_points,
               lib.clear_buffers):
        fn.restype = None
    _cached = lib
    return lib
