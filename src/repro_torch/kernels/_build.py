"""Build the CUDA C++ kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel folder holds ``csrc/<name>.cu`` with a plain C interface; the
sources share the headers of this folder (``common.cuh``, ``hopper.cuh``).
At first use a source is compiled for ``sm_90a`` into
``<checkout>/build/kernels/`` under a name keyed by a hash of it, every
``*.cuh`` under this folder and the flags, so an edited source or header
rebuilds and an unchanged one loads at once. ``build_all`` starts one
``nvcc`` per source, all together. A failed build raises; there is no
fallback. No library links against ``libcuda``: the flash kernel reaches its
``cuTensorMapEncodeTiled`` through the CUDA runtime's entry-point query.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CUDA_KERNELS = ("flash_attention", "decode_attention", "fused_rmsnorm", "ssd")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME)")


def _source(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _headers() -> List[Path]:
    return sorted(KERNELS_DIR.rglob("*.cuh"))


def _target(name: str) -> Path:
    h = hashlib.sha256(_source(name).read_bytes())
    for header in _headers():
        h.update(str(header.relative_to(KERNELS_DIR)).encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names: List[str] = CUDA_KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, in parallel.

    Returns ``{name: ptxas log}`` (registers, shared memory and spills per
    kernel); a library that was already built returns its saved log."""
    with _lock:
        todo = [n for n in names if not _target(n).exists()]
        started = [(n, *_start(n)) for n in todo]
        logs = {}
        for n, proc, tmp, out in started:
            logs[n] = _finish(n, proc, tmp, out)
        for n in names:
            if n not in logs:
                log = _target(n).with_suffix(".log")
                logs[n] = log.read_text() if log.exists() else ""
        return logs


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with the
    ``argtypes`` of each C entry point in ``signatures`` declared (every entry
    point returns a CUDA error code as an int). A loaded library is returned
    without taking the lock: a launch pays one dict lookup."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_target(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({msg})")
