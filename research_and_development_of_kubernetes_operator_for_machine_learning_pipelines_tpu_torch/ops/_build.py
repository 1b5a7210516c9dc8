"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled on its
own with ``nvcc`` into ``build/torch_kernels/<name>-<hash>.so`` at first
use; the hash covers the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited kernel never loads a stale library.  Several
sources build in parallel (one ``nvcc`` each, all started together).
Nothing here imports torch's C++ headers: a plain-C build takes seconds
where a PyTorch extension takes minutes.

A missing ``nvcc`` or a failed build raises; there is no fallback.

Ranks of one host start cold together and would build into one
directory at once: the build and the load hold an exclusive ``flock`` on
``BUILD_DIR/.build.lock``, so one process compiles each library and the
others find it built (the kernel releases the lock of a process that
dies).

``BUILD_DIR`` is the node-local cache of built libraries
(``utils/compile_cache.enable_persistent_compile_cache`` points it
elsewhere, ``--compile-cache-dir``); each build reports its outcome there,
a hit for a library already built and a miss with nvcc's seconds.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..utils import compile_cache

SOURCES = ("decode_attention", "rmsnorm", "flash_attention", "dmajor_attention", "sampling")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> the compiler's register/shared-memory report from the last build
ptxas_reports: dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels build from source at first use"
    )


def library_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


@contextlib.contextmanager
def _dir_lock():
    """The build directory's lock across processes (and threads: each
    holder opens its own file description)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library of ``names`` in parallel; returns
    the wall seconds each build took (0.0 for one already built, here or
    by another process while this one waited for the lock)."""
    with _dir_lock():
        return _build_locked(names)


def _build_locked(names) -> dict[str, float]:
    todo = [n for n in names if not library_path(n).exists()]
    seconds = {n: 0.0 for n in names}
    for n in names:
        if n not in todo:
            compile_cache.note_build(n, hit=True)
    if not todo:
        return seconds
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        ptxas_reports[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(n))  # atomic: a concurrent loader never sees half a file
        compile_cache.note_build(n, hit=False, seconds=seconds[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def current_stream(device) -> int:
    """The raw ``cudaStream_t`` of the current stream on a CUDA ``device``:
    what ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object on every launch (host time that a small
    kernel's call cannot hide)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with _dir_lock():
                if not library_path(name).exists():
                    _build_locked((name,))
                lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
