"""Wheel build hook: compile the native host runtime into the package.

The reference ships its C++/CUDA runtime through setup.py-driven extension
builds (bindings/torch/setup.py there); the analog here is a plain ctypes
shared library (native/tcnn_host.cpp - PCG32 stream + OpenMP bilinear
sampling), compiled here into `tcnn_tpu/libtcnn_host.so` so installed wheels
carry it. If no C++ toolchain is present the wheel is built pure-Python;
every native entry point has a numpy fallback (tcnn_tpu/native.py), so the
package stays fully functional either way.
"""

import os
import shutil
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py
from setuptools.dist import Distribution

_ROOT = os.path.dirname(os.path.abspath(__file__))


def _have_cxx() -> bool:
    return shutil.which(os.environ.get("CXX", "g++")) is not None


class BinaryDistribution(Distribution):
    """Tag the wheel with the build platform when the native lib will be
    compiled in: a py3-none-any wheel embedding a linux-x86_64 .so would
    be installable (and silently broken down to the numpy fallbacks) on
    every other platform. Pure-Python builds (no C++ toolchain) stay
    none-any - there the fallbacks are the intended behavior."""

    def has_ext_modules(self):
        return _have_cxx() and os.path.exists(
            os.path.join(_ROOT, "native", "tcnn_host.cpp")
        )


class build_py_with_native(build_py):
    def run(self):
        super().run()
        src = os.path.join(_ROOT, "native", "tcnn_host.cpp")
        if not os.path.exists(src):
            return
        out = os.path.join(self.build_lib, "tcnn_tpu", "libtcnn_host.so")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cxx = os.environ.get("CXX", "g++")
        cmd = [cxx, "-O3", "-std=c++17", "-fPIC", "-fopenmp", "-Wall",
               "-shared", "-o", out, src]
        try:
            subprocess.run(cmd, check=True, timeout=300)
            print(f"built native host runtime: {out}")
        except Exception as e:  # noqa: BLE001 - pure-Python wheel is valid
            print(f"native host runtime skipped ({e}); numpy fallbacks apply")


setup(
    cmdclass={"build_py": build_py_with_native},
    distclass=BinaryDistribution,
)
