"""Build and bind the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, bound through ``ctypes``.  Nothing builds at
import: the first call of :func:`library` compiles every missing library,
all ``nvcc`` processes started together, into ``build/repro_torch/`` at the
root of the checkout, under names keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads at once.
A missing ``nvcc`` or a failed build raises; nothing falls back.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# C signature of every exported launch function, per library
SIGNATURES = {
    "rsa_gemm": {
        "rsa_gemm_launch": [_I, _I, _I, _I, _P, _LL, _P, _LL, _P,
                            _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "paged_attn": {
        "paged_decode_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _I, _F, _F, _P],
        "paged_prefill_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0     # wall time of the last build (0 if cached)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every library whose target is missing, in parallel; returns
    {name: path}.  Raises with the compiler's output on any failure.  The
    compiler's resource report (``-Xptxas -v``) lands beside each library
    as ``<target>.log``."""
    global build_seconds
    targets = {name: _target(name) for name in SIGNATURES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        build_seconds = 0.0
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.time()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        target = todo[name]
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    build_seconds = time.time() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its functions' argtypes set,
    building every kernel library first if needed."""
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            for lib_name, path in paths.items():
                if lib_name in _LIBS:
                    continue
                lib = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[lib_name].items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                _LIBS[lib_name] = lib
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
