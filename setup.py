"""Build system for horovod_tpu.

Reference parity: the reference's `setup.py` (1460 LoC) builds one C++
extension per framework, gated by `HOROVOD_WITH[OUT]_*` env feature flags,
with compile-probing via `test_compile` (setup.py:352-620). Here there is one
native target — the engine core `libhvd_tpu_core.so` (controller, fusion
planner, response cache, timeline writer, GP autotuner) loaded via ctypes —
and the feature flags are:

  HOROVOD_TPU_WITH_NATIVE=1     require the native core (fail build if the
                                toolchain is missing) — mirrors HOROVOD_WITH_*
  HOROVOD_TPU_WITHOUT_NATIVE=1  skip the native build; the engine falls back
                                to the pure-Python controller — mirrors
                                HOROVOD_WITHOUT_*
  (default)                     best-effort: probe the compiler, build if
                                possible, otherwise warn and continue

The TPU compute path (XLA collectives, Pallas kernels) needs no compilation
here — jax/jaxlib ship it; there is deliberately no CUDA/NCCL probing
(HOROVOD_GPU_ALLREDUCE et al. have no TPU meaning).
"""

import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py

_ROOT = os.path.dirname(os.path.abspath(__file__))
_CORE = os.path.join(_ROOT, "horovod_tpu", "_core")


def _env_flag(name):
    return os.environ.get(name, "").lower() in ("1", "true", "yes")


def _probe_compiler(cxx):
    """`test_compile` analogue (reference setup.py:352): can we build a
    trivial C++17 shared object with -pthread?"""
    if shutil.which(cxx) is None:
        return False
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "probe.cc")
        with open(src, "w") as f:
            f.write(textwrap.dedent("""
                #include <atomic>
                #include <thread>
                extern "C" int hvd_probe() {
                    std::atomic<int> x{41};
                    return x.fetch_add(1) + 1;
                }
            """))
        out = os.path.join(td, "probe.so")
        r = subprocess.run(
            [cxx, "-std=c++17", "-fPIC", "-shared", "-pthread", src, "-o", out],
            capture_output=True)
        return r.returncode == 0


def _build_native(required):
    cxx = os.environ.get("CXX", "g++")
    if not _probe_compiler(cxx) or shutil.which("make") is None:
        msg = (f"toolchain probe failed (CXX={cxx!r}, make="
               f"{shutil.which('make')}); the native engine core will not be "
               "built (pure-Python controller fallback).")
        if required:
            raise RuntimeError(msg + " HOROVOD_TPU_WITH_NATIVE=1 was set.")
        print("WARNING:", msg, file=sys.stderr)
        return False
    r = subprocess.run(["make", "-C", _CORE, f"CXX={cxx}"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        if required:
            raise RuntimeError("native core build failed:\n" + r.stderr)
        print("WARNING: native core build failed; continuing without it:\n"
              + r.stderr, file=sys.stderr)
        return False
    return True


class build_native(Command):
    """`python setup.py build_native` — build just libhvd_tpu_core.so."""

    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        _build_native(required=True)


class build_py_with_native(build_py):
    def run(self):
        if not _env_flag("HOROVOD_TPU_WITHOUT_NATIVE"):
            _build_native(required=_env_flag("HOROVOD_TPU_WITH_NATIVE"))
        super().run()


setup(
    name="horovod_tpu",
    version="0.1.0",
    description=("TPU-native distributed training framework with the "
                 "capabilities of Horovod: named async collectives, tensor "
                 "fusion, distributed optimizers, timeline, autotune, and a "
                 "horovodrun-style launcher — on XLA collectives over "
                 "ICI/DCN meshes."),
    packages=find_packages(include=["horovod_tpu", "horovod_tpu.*",
                                    "horovod_tpu_torch",
                                    "horovod_tpu_torch.*"]),
    package_data={
        "horovod_tpu": ["_core/*.cc", "_core/*.h", "_core/Makefile",
                        "_core/libhvd_tpu_core.so"],
        # the PyTorch/CUDA port builds these with nvcc at first use
        "horovod_tpu_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={
        "flax": ["flax", "optax"],
        "torch": ["torch"],
        "test": ["pytest", "flax", "optax", "Pillow"],
    },
    entry_points={
        "console_scripts": [
            "hvdrun = horovod_tpu.run.launcher:main",
            "horovodrun = horovod_tpu.run.launcher:main",
        ],
    },
    cmdclass={"build_py": build_py_with_native,
              "build_native": build_native},
)
