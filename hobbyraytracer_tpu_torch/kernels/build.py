"""Build and load the hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C interface. At first use
it is compiled by `nvcc` for Hopper (sm_90a) into a shared library under
`build/kernels/` at the repository root (listed in .gitignore) and loaded
with ctypes; it is rebuilt when the source is newer than the library. A
failed build raises with nvcc's stderr: there is no fallback.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no contraction into FMAs: every product and sum rounds on
              # its own, as in the plain PyTorch version beside each kernel
              "-fmad=false"]


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else the CUDA toolkit's default place."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin): the "
            "CUDA kernels are built from source at first use")
    return path


class KernelLibrary:
    """One kernel's shared library, built at first `load()`, and the count
    of its launches (the wrapper adds one per launch)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.build_seconds = 0.0
        self._lib = None
        self._lock = threading.Lock()

    @property
    def source(self) -> str:
        return os.path.join(CSRC, f"{self.name}.cu")

    @property
    def path(self) -> str:
        return os.path.join(BUILD_DIR, f"lib{self.name}.so")

    def _stale(self) -> bool:
        return (not os.path.exists(self.path)
                or os.path.getmtime(self.source) > os.path.getmtime(self.path))

    def build(self) -> None:
        """Compile the source into the library (to a temporary file that is
        renamed into place, so concurrent builders never see half a file)."""
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, self.source],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {self.source} (exit "
                    f"{proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        self.build_seconds = time.perf_counter() - t0

    def load(self) -> ctypes.CDLL:
        """The loaded library, building it first when missing or stale."""
        with self._lock:
            if self._lib is None:
                if self._stale():
                    self.build()
                self._lib = ctypes.CDLL(self.path)
            return self._lib
