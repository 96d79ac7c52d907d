"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(``extern "C"`` entries taking ``void*`` pointers, ints, floats and the
stream), loaded with ``ctypes``.  No PyTorch header is compiled, so a build
takes seconds.  Libraries go to ``build/repro_torch/`` at the root of the
checkout (git-ignored) under a name that carries a hash of the sources and
flags, so an edited source is never served by a stale binary.  All sources
build in parallel, one ``nvcc`` each.  One lock covers the build and the
loaders, so threads that reach a kernel first at the same time (a
service's thread and its caller) build and load each library once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("sweep_csr", "spmv_csr", "spmv_ell", "bbmv", "banded_gs",
           "block_gs", "colsum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# (value dtype, index dtype) pairs the operators produce -> C entry suffix
SUFFIX = {(torch.float32, torch.int32): "f32_i32",
          (torch.bfloat16, torch.int16): "bf16_i16",
          (torch.bfloat16, torch.int32): "bf16_i32"}
# value dtype of the band-tile kernels (no index stream) -> C entry suffix
VALUE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict[str, object] = {}
# Reentrant: library() builds through build_all() under it.
_lock = threading.RLock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of repro_torch cannot be built")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in [*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(*, verbose: bool = False) -> dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
    of each kernel) and prints the compiler's output and the build time.
    Raises ``RuntimeError`` with the compiler's output if a build fails.
    """
    with _lock:
        return _build_all(verbose)


def _build_all(verbose: bool) -> dict[str, Path]:
    extra = ("-Xptxas", "-v") if verbose else ()   # output only, same binary
    targets = {name: _target(name) for name in SOURCES}
    todo = {name: t for name, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{out}")
            continue
        os.replace(tmp, target)
        if verbose:
            print(f"[build] {name}.cu -> {target.name}", flush=True)
            for line in out.splitlines():
                if "entry function" in line or "Used" in line or \
                        "spill" in line or "warning" in line:
                    print(f"[build]   {line.strip()[:160]}", flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    if verbose:
        print(f"[build] {len(todo)} source(s) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            if name not in _loaded:
                _loaded[name] = ctypes.CDLL(str(build_all()[name]))
            lib = _loaded[name]
    return lib


def entry(source: str, name: str, argtypes):
    """The C entry ``name`` of ``csrc/<source>.cu``, returning int, with its
    argument types declared."""
    if name not in _entries:
        fn = getattr(library(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return _entries[name]


def c_entry(source: str, kernel: str, vals_dtype, cols_dtype, argtypes):
    """The C entry ``<kernel>_<suffix>`` of ``csrc/<source>.cu`` for this
    value/index type pair (``cols_dtype=None``: a kernel with no index
    stream, keyed by the value type alone), with its argument types
    declared."""
    suffix = (VALUE_SUFFIX[vals_dtype] if cols_dtype is None
              else SUFFIX[(vals_dtype, cols_dtype)])
    return entry(source, f"{kernel}_{suffix}", argtypes)


def check_launch(err: int, kernel: str) -> None:
    """Raise if a C entry reported a launch error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
