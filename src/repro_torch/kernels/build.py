"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each library is built for one configuration: the tunables arrive as
``-D`` defines, as CLTune recompiles its OpenCL source with new
``#define``\\ s.  Libraries are cached in ``build/kernels/`` at the root of
the checkout (found from this file, not from the working directory) under
a hash of the source bytes, the defines and the compiler flags.  That hash
is also the build's content address, ``cuda:<digest>``.  Threads and
processes that ask for the same configuration at once wait for one
``nvcc`` run: a thread lock per library in a process, and an exclusive
``flock`` on ``<library>.lock`` across processes (a fleet of tuning
workers), taken around the exists-or-compile step, so each library is
built at most once.  A library is written under a temporary name and moved
into place, so no process loads a half-written file.  Every ``nvcc`` run
appends one JSON line to ``build/kernels/nvcc.jsonl`` (library, seconds,
process id): the record of what was built, and by whom.

Nothing here runs when the module is imported: the CPU tests import every
module, and this host may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Any, Dict, List, Mapping, Sequence, Tuple

from ..core import trace
from ..core.cache import FileLock
from ..core.paths import KERNEL_BUILD_DIR as BUILD_DIR
#: one JSON line per nvcc run, in BUILD_DIR
BUILD_LOG = "nvcc.jsonl"

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
    lib = library_path(name, key)
    with _LOCK:
        building = _BUILDING.setdefault(key, threading.Lock())
    with building:
        if not os.path.exists(lib):
            os.makedirs(os.path.dirname(lib), exist_ok=True)
            with FileLock(lib[:-3] + ".lock"):
                if not os.path.exists(lib):
                    _compile(source, defines, name, lib)
    return lib, f"cuda:{key}"


def library_path(name: str, key: str) -> str:
    """Where ``build`` keeps the library ``name`` with digest ``key``."""
    return os.path.join(BUILD_DIR, f"{name}-{key}.so")


def _compile(source: str, defines: Mapping[str, int], name: str,
             lib: str) -> None:
    out_dir = os.path.dirname(lib)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=f".{name}-",
                               suffix=".so")
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *_define_flags(defines), "-o", tmp,
           source]
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {name} "
                f"{dict(defines)}:\n{proc.stderr[-4000:]}")
        with open(lib[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
        record_build(lib, time.perf_counter() - t0)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def record_build(lib: str, seconds: float) -> None:
    """Append one line for a finished build to the build log beside it
    (one ``write`` of a short line in append mode: lines from concurrent
    processes do not interleave)."""
    line = json.dumps({"library": os.path.basename(lib), "s": seconds,
                       "pid": os.getpid()}) + "\n"
    with open(os.path.join(os.path.dirname(lib), BUILD_LOG), "a") as f:
        f.write(line)


def read_build_log(build_dir: str = "") -> List[Dict[str, Any]]:
    """Every line of the build log in ``build_dir`` (default
    :data:`BUILD_DIR`), oldest first; [] when nothing was built."""
    path = os.path.join(build_dir or BUILD_DIR, BUILD_LOG)
    try:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except FileNotFoundError:
        return []


def log_path(name: str, address: str) -> str:
    """The compiler's output kept beside the library that ``build`` made
    under ``name`` with content address ``address`` (``cuda:<digest>``)."""
    return os.path.join(BUILD_DIR, f"{name}-{address.split(':', 1)[1]}.log")


def load(source: str, defines: Mapping[str, int], name: str
         ) -> Tuple[ctypes.CDLL, str]:
    """Build (if needed) and load one library; loaded once per process."""
    with trace.span("build.load"):
        lib_path, address = build(source, defines, name)
        with _LOCK:
            lib = _LIBS.get(lib_path)
            if lib is None:
                lib = _LIBS[lib_path] = ctypes.CDLL(lib_path)
    return lib, address
