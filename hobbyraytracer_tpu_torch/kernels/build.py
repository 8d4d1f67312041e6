"""Build and load the hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C interface (device code
shared between kernels lives in `csrc/*.cuh`). At first use it is compiled
by `nvcc` for Hopper (sm_90a) into a shared library under `build/kernels/`
at the repository root (listed in .gitignore) and loaded with ctypes; it is
rebuilt when its source or a header is newer than the library. A failed
build raises with nvcc's stderr: there is no fallback. ptxas reports each
kernel's registers and spills on a build (`KernelLibrary.ptxas_info`).

`GraphReplay` runs a function through a CUDA graph and keeps the launch
counts of a replayed graph equal to an eager run's (the render's blocks,
integrator/wavefront.py:_BlockGraph, the fit's steps,
diff/fit.py:fit_materials, and the batch integrator's sample steps,
integrator/path.py:BatchRun). While tracing is on (tracing.py) it records
the spans hrt.graph.record, hrt.graph.instantiate and hrt.graph.replay,
tells the traced job which pass runs (eager, capture, replay), and counts
the captured graph's nodes by type before instantiating it.

Every wrapper picks its version by `runs_plain` (the plain PyTorch one for
CPU tensors) and launches through `KernelLibrary.launch`. Comparisons
(tests, chip_smoke.py) switch in one place, by context managers that
restore what they found: inside `plain_versions()` the finds' wrappers
(K1-K4, the sphere scan; not threefry's draws) run their plain versions
on CUDA tensors too; inside either that or `eager()` nothing is captured
(`graphs_on`, the rule that the routes share).
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time
import weakref

import numpy as np
import torch
from torch import nn

from .. import tracing

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no contraction into FMAs: every product and sum rounds on
              # its own, as in the plain PyTorch version beside each kernel
              "-fmad=false",
              # registers, spills and shared memory of each kernel
              "-Xptxas", "-v"]

# every KernelLibrary alive, so that a replayed CUDA graph can add the
# launches it captured to each (GraphReplay)
LIBRARIES = weakref.WeakSet()
# the ctypes types of the kernels' C arguments
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the comparison switches (plain_versions, eager)
SWITCHES = {"plain": False, "eager": False}


@contextlib.contextmanager
def _switched(name: str):
    before, SWITCHES[name] = SWITCHES[name], True
    try:
        yield
    finally:
        SWITCHES[name] = before


def plain_versions():
    """Inside: the finds run their plain versions on CUDA tensors too."""
    return _switched("plain")


def eager():
    """Inside: nothing is captured into a CUDA graph."""
    return _switched("eager")


def graphs_on(device) -> bool:
    """May a step on `device` be captured into a CUDA graph? On a CUDA
    device outside both switches; each route adds its own rules."""
    return (torch.device(device).type == "cuda"
            and not (SWITCHES["plain"] or SWITCHES["eager"]))


def runs_plain(device, find: bool = True) -> bool:
    """Does a kernel wrapper run its plain version for tensors on `device`?
    On the CPU; on a card inside plain_versions(), for a `find`."""
    return torch.device(device).type == "cpu" or (find and SWITCHES["plain"])


def check(name, x, dtype, shape, device) -> None:
    """A kernel argument's checks: on `device`, of `dtype` and `shape`,
    contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the launch on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def f32(x: float) -> float:
    """x rounded to float32, as a kernel receives a float argument."""
    return float(np.float32(x))


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
    of its launches (`launch` adds one each). The library exports one C
    function, hrt_<name>, whose last argument is the stream and which
    returns a CUDA error code. `csrc` and `build_dir` default to the
    package's sources and build directory; a timing script gives others to
    build the same kernel from another tree (scripts/time_mesh_kernels.py)."""

    def __init__(self, name: str, csrc: str | None = None,
                 build_dir: str | None = None):
        self.name = name
        self._csrc = csrc
        self._build_dir = build_dir
        self.launches = 0
        self.build_seconds = 0.0
        self.build_log = ""
        self._lib = None
        self._fn = None
        self._lock = threading.Lock()
        LIBRARIES.add(self)

    @property
    def csrc(self) -> str:
        return self._csrc or CSRC

    @property
    def build_dir(self) -> str:
        return self._build_dir or BUILD_DIR

    @property
    def source(self) -> str:
        return os.path.join(self.csrc, f"{self.name}.cu")

    @property
    def path(self) -> str:
        return os.path.join(self.build_dir, f"lib{self.name}.so")

    def _stale(self) -> bool:
        if not os.path.exists(self.path):
            return True
        newest = max(os.path.getmtime(f) for f in
                     [self.source,
                      *glob.glob(os.path.join(self.csrc, "*.cuh"))])
        return newest > os.path.getmtime(self.path)

    @property
    def ptxas_info(self) -> list:
        """ptxas's lines on each kernel of the last build (registers,
        spill stores and loads, shared memory)."""
        return [ln.strip() for ln in self.build_log.splitlines()
                if "spill" in ln or ("ptxas info" in ln and (
                    "Used" in ln or "Compiling" in ln))]

    def build(self) -> None:
        """Compile the source into the library (to a temporary file that is
        renamed into place, so concurrent builders never see half a file)."""
        nvcc = find_nvcc()
        os.makedirs(self.build_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
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
            self.build_log = proc.stderr
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

    def device_for(self, device) -> torch.device:
        """`device`, checked as a CUDA one, once the library is loaded (a
        kernel that cannot be built raises first, on any device)."""
        self.load()
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"the {self.name} kernel needs CUDA tensors, "
                             f"got {device}")
        return device

    def launch(self, argtypes, device, *args) -> None:
        """hrt_<name>(*args, stream) on `device` and its current stream (C
        argument types `argtypes`, bound at the first launch); raise on a
        CUDA error; count the launch. No allocation, no host read: a CUDA
        graph may capture it."""
        if self._fn is None:
            fn = getattr(self.load(), f"hrt_{self.name}")
            fn.argtypes = [*argtypes, PTR]
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):   # the launch goes to its card
            err = self._fn(*args,
                           torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1


def held(value, tensors: list):
    """What a CUDA graph recorded over `value` (a scene or a camera, or a
    part of one) takes as fixed, as a hashable value: each module's type,
    its plain attributes (flags such as Camera.use_lens and TextureTable.
    bilinear, which the recorded work branches on) and its parts; each
    tensor's address, shape, strides, dtype and device (the graph reads it
    in place). Appends each tensor met to `tensors`, and each object that
    is told apart only by its identity."""
    if isinstance(value, torch.Tensor):
        tensors.append(value)
        return ("tensor", value.data_ptr(), tuple(value.shape),
                value.stride(), value.dtype, value.device)
    if isinstance(value, nn.Module):
        parts = {**value._parameters, **value._buffers, **value._modules}
        parts.update((k, v) for k, v in vars(value).items()
                     if not k.startswith("_") and k != "training")
        return (type(value),) + tuple((k, held(parts[k], tensors))
                                      for k in sorted(parts))
    if isinstance(value, (tuple, list)):
        return (type(value),) + tuple(held(v, tensors) for v in value)
    try:
        hash(value)
    except TypeError:   # no value to compare: the object itself, held
        tensors.append(value)
        return ("object", id(value))
    return value


class GraphReplay:
    """A function of no arguments run through one CUDA graph: eagerly the
    first time (the warm-up), captured the second and replayed at once,
    replayed from then on. The function must run the same work on the same
    tensors every time, reading no host value and copying nothing from the
    host: the graph replays what the capture recorded. The warm-up runs
    that very function, so every kernel is built and loaded and the
    allocator holds its sizes before the capture starts.

    A kernel wrapper counts its launch when the capture records it, where
    nothing runs: the capture's counts are taken back and added again at
    every replay, so the counts are an eager run's. The capture is made on
    a stream of `device` in thread-local mode: another thread may use the
    card meanwhile. A failed capture or replay raises; nothing runs the
    function eagerly in its place.

    Several graphs may share one capture stream and one memory pool
    (`stream`, `pool` from torch.cuda.graph_pool_handle()) when they never
    run at once and pass data only through tensors allocated outside the
    pool; their owner then calls `capture` and `replay` itself, in the
    order the graphs run."""

    def __init__(self, device, stream=None, pool=None):
        self.device = torch.device(device)
        self.stream = stream or torch.cuda.Stream(self.device)
        self.pool = pool
        self.warm = False
        self.graph = None
        self.out = None
        self.launches = {}

    def capture(self, fn) -> None:
        """Record fn() into the graph: nothing runs. The garbage collector
        is off meanwhile: a collection that freed another CUDA graph would
        reset it inside this capture, which the card refuses (the capture
        would fail)."""
        before = {lib: lib.launches for lib in LIBRARIES}
        traced = tracing.ACTIVE is not None
        # traced: the graph is kept past the capture, its nodes counted,
        # and instantiated in a span of its own
        self.graph = (torch.cuda.CUDAGraph(keep_graph=True) if traced
                      else torch.cuda.CUDAGraph())
        collecting = gc.isenabled()
        gc.disable()
        try:
            with tracing.span("graph.record"), torch.cuda.graph(
                    self.graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                self.out = fn()
        finally:
            if collecting:
                gc.enable()
        if traced:
            tracing.count_graph_nodes(self.graph)
            with tracing.span("graph.instantiate"):
                self.graph.instantiate()
        for lib, n in before.items():
            if lib.launches != n:
                self.launches[lib] = lib.launches - n
                lib.launches = n

    def replay(self):
        """Run the captured graph on the current stream -> fn()'s result
        as captured (the graph's own tensors)."""
        with tracing.span("graph.replay"):
            self.graph.replay()
        for lib, n in self.launches.items():
            lib.launches += n
        return self.out

    def __call__(self, fn):
        """fn() by this graph's turn -> its result (after a replay, the
        graph's own tensors, valid until the next replay). The caller makes
        `device` current."""
        tracing.set_route("eager" if not self.warm else
                          "capture" if self.graph is None else "replay")
        if self.warm and self.graph is None:
            self.capture(fn)
        if self.graph is None:
            out = fn()
            self.warm = True
            return out
        return self.replay()
