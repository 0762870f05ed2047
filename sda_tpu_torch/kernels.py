"""Build and load the port's CUDA kernels from the sources in ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain C entry points and is compiled by
``nvcc`` into ``build/sda_tpu_torch/lib<name>-<hash>.so`` at the checkout's
root (``build/`` is git-ignored), then loaded with ``ctypes``. The file name
carries a hash of the source, so an edited kernel is rebuilt and a built one
is reused. Nothing is compiled or loaded at import time: only
``load``/``build_all`` do, on a host with the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sda_tpu_torch"

#: kernel name -> {C entry point: its argtypes}
KERNELS = {
    "limb_share_sum": {
        "limb_share_sum_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    },
    "chacha20": {
        "chacha20_launch": [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_longlong, ctypes.c_longlong,
                            ctypes.c_void_p, ctypes.c_void_p],
        "chacha20_expand_launch": [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_ulonglong] * 3
                                  + [ctypes.c_void_p] * 4,
    },
    "dgauss": {
        "dgauss_launch": [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_double] * 3 + [ctypes.c_void_p] * 3,
    },
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one kernel; ``None`` when it is already built."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib


def _finish_build(name: str, started) -> str:
    """Wait for ``nvcc``; returns its output (ptxas' report)."""
    proc, tmp, lib = started
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{output}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return output


def build_all() -> dict[str, str]:
    """Compile every kernel not yet built, one ``nvcc`` per source, all
    started together; returns each new build's compiler output by name."""
    started = {name: _start_build(name) for name in KERNELS}
    return {
        name: _finish_build(name, handle)
        for name, handle in started.items()
        if handle is not None
    }


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        handle = _start_build(name)
        if handle is not None:
            _finish_build(name, handle)
        lib = ctypes.CDLL(str(library_path(name)))
        for entry, argtypes in KERNELS[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
