"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), cached
under ``build/torch_kernels/`` at the root of the checkout by a hash of the
source, of every ``csrc`` header it includes (``#include "x.cuh"``, followed
through the headers' own includes) and of the flags. The build writes to a
per-process temporary name and renames it into place, so ranks that start
together never load a half-written library. Sources come only from this
package.

``--use_fast_math`` stays off: the quantizers' bits and the Adasum
coefficients depend on IEEE division, and the quantizers' on denormals being
kept.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()  # guards _name_locks
_name_locks: dict = {}    # one per library: different sources build at once
_libs: dict = {}
_logs: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises if none has it."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of horovod_tpu_torch are built at first use")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, directly or
    through another header, each once, in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(
            path.read_bytes()) if (CSRC / inc.decode()).is_file()]
    return found


def library_path(name: str) -> Path:
    """Where the build of ``name`` lives: a change to its source, to a
    header it includes or to the flags names another library."""
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, compiling it if no build
    of this exact source exists yet. Threads may load different libraries
    at once; each build is its own ``nvcc`` process."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{res.stderr}")
            os.replace(tmp, out)
            _logs[name] = res.stdout + res.stderr
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def compile_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed when this process built ``name``
    (registers, shared memory and spills per kernel); empty when the library
    was already built."""
    return _logs.get(name, "")
