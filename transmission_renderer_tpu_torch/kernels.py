"""Build, load and account for the hand-written CUDA kernels.

The port's kernels live as CUDA C++ sources under ``csrc/``. At first
use each source is compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and the objects are linked into one
shared library with a plain C interface under ``_build/`` (a directory
``.gitignore`` lists), which is loaded with ``ctypes``: pointers
come from ``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``. Every C entry returns
``cudaGetLastError()``; ``launch`` raises when it is not 0.

``--fmad=false`` keeps ``a * b + c`` as a rounded multiply and a rounded
add, as the plain PyTorch versions and the reference compute it, so the
raster's edge functions and depths round the same way on both sides.
Fast math stays off (IEEE division and square root).

Each kernel module owns one ``KernelHandle``: the kernel's two
implementations (the CUDA launch and the plain PyTorch version, with one
signature), its launch count (a plain integer, raised by one where the
kernel is launched and nowhere else) and an optional recorder that keeps
the arguments of each call, so a checker can replay the same inputs
through both implementations. Every handle is listed in ``HANDLES``,
where the frame tracer (utils/profiling.py) reads the launch counts.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("raster_gbuf.cu", "tap_finish.cu", "shade.cu", "transmission_fetch.cu",
           "bvh_occlusion.cu", "raster_vis.cu", "bvh_closest.cu", "clip_alpha.cu",
           "clip_peel.cu")
HEADERS = ("common.cuh", "work_list.cuh", "atlas_tap.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)


# every KernelHandle made, in the order made
HANDLES: list = []


class KernelHandle:
    """One kernel: its implementations and its launch accounting."""

    def __init__(self, name: str, source: str, replaces: str, cuda, plain):
        self.name = name
        self.source = source  # repo path of the CUDA source
        self.replaces = replaces  # file:line of the TPU kernel
        self.cuda = cuda  # launches the kernel (CUDA tensors)
        self.plain = plain  # the plain PyTorch version (any device)
        self.launches = 0
        self.recorder: list | None = None
        HANDLES.append(self)

    def __call__(self, on_cuda: bool, *args, **kwargs):
        """Record the call, then run the kernel for CUDA operands and the
        plain version otherwise (no fallback between them)."""
        if self.recorder is not None:
            self.recorder.append((args, kwargs))
        return (self.cuda if on_cuda else self.plain)(*args, **kwargs)

    def replay(self, call, on_cuda: bool):
        """Run a recorded call through the kernel or the plain version."""
        args, kwargs = call
        return (self.cuda if on_cuda else self.plain)(*args, **kwargs)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


class BuildInfo:
    def __init__(self, path: Path, seconds: float, log: str, built: bool):
        self.path = path
        self.seconds = seconds
        self.log = log
        self.built = built


@functools.lru_cache(maxsize=1)
def build() -> BuildInfo:
    """Compile csrc/*.cu into _build/ (skipped when an up-to-date
    library for the same sources and flags is already there): one nvcc
    per source in parallel, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libtrt_kernels_{_digest()}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "", built=False)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                          str(CSRC / s)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
    return BuildInfo(lib, seconds, log, built=True)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build().path))


def entry(name: str, argtypes: list):
    """A C entry point of the kernel library with its argument types."""
    fn = getattr(_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(handle: KernelHandle, fn, *args) -> None:
    """Call a C entry on the current stream; raise on a launch error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{handle.name}: CUDA launch failed with error {err}")
    handle.launches += 1


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          device: torch.device | None = None, align: int = 1) -> None:
    """Validate a kernel operand before its pointer is passed (``align``:
    the byte alignment its vector loads need)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: not aligned to {align} bytes")


VOIDP = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
