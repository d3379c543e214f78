"""Build and load the port's CUDA kernels.

Every source in `tpu_fluid_torch/csrc/` compiles, by `nvcc` for `sm_90a`,
into one shared library with a plain C interface, loaded with `ctypes`.  The
build runs at first use into `build/tpu_fluid_torch/` beside the package,
and again whenever a source is newer than the library: one `nvcc` per
source, all started together, then one link.  Nothing here runs at import
time: the CPU tests import every module on machines without `nvcc`.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()` after its launches; `call` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "tpu_fluid_torch"
LIBRARY = BUILD_DIR / "libtpu_fluid_kernels.so"

# -fmad=false: no a*b+c contraction, so each kernel rounds exactly where its
# plain PyTorch version (one elementwise op per PyTorch kernel) rounds, and
# the two agree bitwise.  --use_fast_math stays off: it would replace the
# IEEE divisions of the Jacobi decode and the signed field.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

POINTER = ctypes.c_void_p
INT = ctypes.c_int
INT64 = ctypes.c_longlong
FLOAT = ctypes.c_float


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _inputs() -> list[Path]:
    return sources() + sorted(CSRC_DIR.glob("*.cuh"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def compile_command(source: Path, output: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-c", str(source), "-o", str(output)]


def link_command(objects: list[Path], output: Path) -> list[str]:
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(output), *(str(o) for o in objects)]


def _run_all(commands: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    failed = None
    for cmd, proc in zip(commands, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
    if failed:
        raise RuntimeError(failed)


def is_stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(src.stat().st_mtime > built for src in _inputs())


def build(force: bool = False) -> Path:
    """Compile the library unless it is up to date.  Objects and the
    library go to a temporary directory first and the library is renamed
    into place, so concurrent builds never load a half-written one."""
    if not force and not is_stale():
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        _run_all([compile_command(src, obj)
                  for src, obj in zip(sources(), objects)])
        library = Path(tmp) / LIBRARY.name
        _run_all([link_command(objects, library)])
        os.replace(library, LIBRARY)
    return LIBRARY


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.tf_error_string.argtypes = [INT]
    lib.tf_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def kernel_function(name: str, argtypes: tuple,
                    restype=INT) -> ctypes._CFuncPtr:
    """The C entry point `name`, with every pointer and the stream declared
    as c_void_p so that ctypes passes them at full width."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def launches(name: str) -> int:
    """The count of kernels launched so far that the C entry point `name`
    keeps (`tf_jacobi_launches`, `tf_surface_launches`,
    `tf_grid_fused_launches`): what one wrapper call launched on the card,
    read before and after it."""
    return int(kernel_function(name, (), INT64)())


@functools.cache
@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def call(name: str, argtypes: tuple, *args) -> None:
    """Launch through entry point `name` and raise on a nonzero
    cudaError_t."""
    err = kernel_function(name, argtypes)(*args)
    if err != 0:
        msg = library().tf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
