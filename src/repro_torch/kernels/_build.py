"""Build the CUDA sources in ``repro_torch/csrc`` with nvcc and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``build/repro_torch/lib<name>-<hash>.so`` under the repository
root, compiled at first use for ``sm_90a`` and loaded with ``ctypes``.  The
file name carries a hash of the source, so an edited source is rebuilt and
never served stale.  Any failure to find nvcc, compile or load raises.

Launch counts live here too: each kernel wrapper adds one to its entry of
``LAUNCHES`` where it launches its kernel, and nowhere else, so a run can
show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

__all__ = ["SOURCES", "LAUNCHES", "build", "function", "reset_launches", "check",
           "require"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
SOURCES = ("seal", "polymul", "rans")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: Dict[str, int] = {"seal": 0, "unseal": 0, "polymul": 0, "rans_encode": 0,
                            "rans_decode": 0, "rans_decode_v0": 0}

_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Callable[..., int]] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one nvcc each, all
    started together.  Returns the library path of each name."""
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])  # atomic: a concurrent build sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def _load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry ``symbol`` of ``csrc/<name>.cu``, typed once and cached:
    pointers and the stream as ``c_void_p``, returning a CUDA error code."""
    with _lock:
        fn = _fns.get((name, symbol))
        if fn is None:
            fn = getattr(_load(name), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[(name, symbol)] = fn
        return fn


def check(status: int, what: str) -> None:
    """Raise if a C launch entry returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")


def require(t, name: str, dtype, shape: Sequence[int], device) -> None:
    """Check one kernel operand: device, dtype, shape, contiguity, alignment."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
