"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each library is built for one configuration: the tunables arrive as
``-D`` defines, as CLTune recompiles its OpenCL source with new
``#define``\\ s.  Libraries are cached in ``build/kernels/`` at the root of
the checkout (found from this file, not from the working directory) under
a hash of the source bytes, the defines and the compiler flags.  That hash
is also the build's content address, ``cuda:<digest>``.  Threads that ask
for the same configuration at once wait for one ``nvcc`` run; a library is
written under a temporary name and moved into place, so no process loads a
half-written file.

Nothing here runs when the module is imported: the CPU tests import every
module, and this host may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Mapping, Sequence, Tuple

#: root of the checkout: src/repro_torch/kernels/build.py -> ../../..
REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         "..", ".."))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")

#: Hopper only: ``sm_90a`` keeps wgmma and setmaxnreg available to kernels
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: one lock per content address, held while that library is built
_BUILDING: Dict[str, threading.Lock] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$NVCC``, else ``nvcc`` on the PATH, else the
    toolkit under ``$CUDA_HOME`` (default ``/usr/local/cuda``)."""
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put "
                           "the CUDA toolkit's bin/ on the PATH")
    return path


def _define_flags(defines: Mapping[str, int]) -> Tuple[str, ...]:
    return tuple(f"-D{k}={int(v)}" for k, v in sorted(defines.items()))


def digest(source: str, defines: Mapping[str, int],
           flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Content address of one build: source bytes, defines and flags."""
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update("\0".join(_define_flags(defines) + tuple(flags)).encode())
    return h.hexdigest()[:24]


def build(source: str, defines: Mapping[str, int], name: str
          ) -> Tuple[str, str]:
    """Compile ``source`` with ``defines`` unless the library is cached.

    Returns ``(library path, "cuda:<digest>")``.  The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library as ``<name>-<digest>.log``."""
    key = digest(source, defines)
    lib = os.path.join(BUILD_DIR, f"{name}-{key}.so")
    with _LOCK:
        building = _BUILDING.setdefault(key, threading.Lock())
    with building:
        if not os.path.exists(lib):
            _compile(source, defines, name, lib)
    return lib, f"cuda:{key}"


def _compile(source: str, defines: Mapping[str, int], name: str,
             lib: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-",
                               suffix=".so")
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *_define_flags(defines), "-o", tmp,
           source]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {name} "
                f"{dict(defines)}:\n{proc.stderr[-4000:]}")
        with open(lib[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def log_path(name: str, address: str) -> str:
    """The compiler's output kept beside the library that ``build`` made
    under ``name`` with content address ``address`` (``cuda:<digest>``)."""
    return os.path.join(BUILD_DIR, f"{name}-{address.split(':', 1)[1]}.log")


def load(source: str, defines: Mapping[str, int], name: str
         ) -> Tuple[ctypes.CDLL, str]:
    """Build (if needed) and load one library; loaded once per process."""
    lib_path, address = build(source, defines, name)
    with _LOCK:
        lib = _LIBS.get(lib_path)
        if lib is None:
            lib = _LIBS[lib_path] = ctypes.CDLL(lib_path)
    return lib, address
