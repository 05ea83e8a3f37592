"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds, not minutes. Libraries are built at
first use into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads the existing library.
Nothing is built or loaded when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"

#: kernel library name -> its CUDA source
SOURCES = {"mlp_kernel": _CSRC / "mlp_kernel.cu"}

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # print each kernel's registers, shared memory and spills into the log
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build with the CUDA "
            "toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=None) -> dict[str, dict]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together. Returns, per
    name, the library path, whether it was built now, the build seconds
    and the compiler's log. Raises ``RuntimeError`` with the log if any
    build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, procs = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            log_path = path.with_suffix(".log")
            results[name] = {
                "path": str(path), "built": False, "seconds": 0.0,
                "log": log_path.read_text() if log_path.exists() else "",
            }
            continue
        tmp = path.with_name(f".tmp-{os.getpid()}-{path.name}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (path, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failures = []
    for name, (path, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        results[name] = {"path": str(path), "built": True, "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes/restype for every entry point: pointers and the stream as
    ``c_void_p`` (a bare Python int would be cut to 32 bits), ints as
    ``c_int``."""
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    for fn in (lib.mlp_forward_f32, lib.mlp_forward_bf16, lib.mlp_forward_int8):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ptrs, ptrs, ptrs,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lib.mlp_max_dynamic_smem.argtypes = [ctypes.c_int]
    lib.mlp_max_dynamic_smem.restype = ctypes.c_int
    lib.mlp_error_string.argtypes = [ctypes.c_int]
    lib.mlp_error_string.restype = ctypes.c_char_p


def load_library(name: str = "mlp_kernel") -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            info = build_all([name])[name]
            lib = ctypes.CDLL(info["path"])
            _declare(lib)
            _LIBS[name] = lib
        return lib
