"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` (one ``nvcc`` per source, all
started together) and linked into one shared library with a plain C interface,
at first use, into ``build/repro_torch_kernels/`` at the root of the
checkout.  The library's name carries a hash of the sources and flags, so
an unchanged tree is not rebuilt.  It is loaded with ``ctypes``: pointers
and the stream pass as ``c_void_p``, and every entry point returns
``cudaGetLastError()``, which ``check`` turns into an exception.  No
PyTorch headers are compiled, so a build takes seconds.  A missing
``nvcc`` or a failed build raises: there is no fallback.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# dtype codes shared with csrc/common.cuh (enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None
build_seconds = 0.0     # wall time of this process's build (0 if cached)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if path is None and (toolkit / "bin" / "nvcc").exists():
        path = str(toolkit / "bin" / "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the repro_torch CUDA kernels "
                           "cannot be built on this machine")
    return path


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def _run(cmds) -> None:
    """Run the ``nvcc`` commands all at once; raise with the output of
    each that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _compile(out: Path, parallel: bool = True) -> None:
    """Build every csrc/*.cu into the library ``out``: one ``nvcc -c`` per
    source, all started together, then one link; or, with
    ``parallel=False``, one ``nvcc`` call for all the sources."""
    nvcc = _nvcc()
    srcs = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    # --cudart shared: use the CUDA runtime PyTorch has already loaded
    # (the toolkit's, through the rpath, if none is loaded yet)
    rpath = Path(nvcc).resolve().parents[1] / "lib64"
    link = [nvcc, *ARCH_FLAGS, "-shared", "--cudart", "shared",
            f"-Xlinker=-rpath,{rpath}", "-o", str(out)]
    if not parallel:
        _run([[*link, *COMPILE_FLAGS, *srcs]])
        return
    work = out.with_name(f"{out.name}.objs")
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs = [str(work / f"{Path(src).stem}.o") for src in srcs]
        _run([[nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", src, "-o", obj]
              for src, obj in zip(srcs, objs)])
        _run([[*link, *objs]])
    finally:
        shutil.rmtree(work, ignore_errors=True)


def build() -> Path:
    """Compile every csrc/*.cu into one library unless it is up to date."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    _compile(tmp)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types set."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


_entries: dict = {}


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, what: str) -> None:
    """Raise on an input a kernel does not take."""
    if not cond:
        raise ValueError(what)


def compare_builds() -> dict:
    """Seconds of a fresh build of the current sources, both ways: one
    ``nvcc`` per source started together plus a link, and one ``nvcc`` call
    for all the sources.  Nothing is cached or loaded.  On the card's
    machine:

        PYTHONPATH=src python -c 'from repro_torch.kernels import _build; print(_build.compare_builds())'
    """
    times = {}
    scratch = BUILD_DIR / f"compare.{os.getpid()}"
    scratch.mkdir(parents=True, exist_ok=True)
    try:
        for name, parallel in (("parallel", True), ("one_call", False)):
            t0 = time.perf_counter()
            _compile(scratch / f"{name}.so", parallel=parallel)
            times[name] = time.perf_counter() - t0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return times

