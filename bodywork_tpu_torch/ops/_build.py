"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds, not minutes. Libraries are built at
first use into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source, the shared headers and
the flags, so an edited source or header rebuilds and an unchanged one
loads the existing library.
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

#: kernel library name -> its CUDA source (which may include the headers
#: ``csrc/*.cuh``)
SOURCES = {
    "mlp_kernel": _CSRC / "mlp_kernel.cu",
    "mlp_bf16_tc": _CSRC / "mlp_bf16_tc.cu",
    "mlp_int8": _CSRC / "mlp_int8.cu",
}

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
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + headers + "\0".join(NVCC_FLAGS).encode()
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


_PTRS = ctypes.POINTER(ctypes.c_void_p)
_INTS = ctypes.POINTER(ctypes.c_int)
_P, _I = ctypes.c_void_p, ctypes.c_int
#: (x, out, n_rows, n_layers, d_in, kp, np, w, b, then f32 and bf16:
#: cluster, stages, smem_bytes, stream; int8: scale, cluster, smem_bytes,
#: stream)
_CLUSTER_FORWARD = [_P, _P, _I, _I, _I, _INTS, _INTS, _PTRS, _PTRS]

#: library -> every ``extern "C"`` entry point of its source, as
#: (argtypes, restype): pointers and the stream as ``c_void_p`` (a bare
#: Python int would be cut to 32 bits), ints as ``c_int``
DECLARATIONS = {
    "mlp_kernel": {
        "mlp_f32_forward": (_CLUSTER_FORWARD + [_I, _I, _I, _P], _I),
        "mlp_f32_max_active_clusters": ([_I, _I], _I),
        "mlp_f32_error_string": ([_I], ctypes.c_char_p),
    },
    "mlp_bf16_tc": {
        "mlp_bf16_forward": (_CLUSTER_FORWARD + [_I, _I, _I, _P], _I),
        "mlp_bf16_max_active_clusters": ([_I, _I], _I),
        "mlp_bf16_error_string": ([_I], ctypes.c_char_p),
    },
    "mlp_int8": {
        "mlp_int8_forward": (_CLUSTER_FORWARD + [_PTRS, _I, _I, _P], _I),
        "mlp_int8_max_active_clusters": ([_I, _I], _I),
        "mlp_int8_error_string": ([_I], ctypes.c_char_p),
    },
}


def _declare(lib: ctypes.CDLL, name: str) -> None:
    """argtypes/restype for every entry point of library ``name``."""
    for fn_name, (argtypes, restype) in DECLARATIONS[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (a key of :data:`SOURCES`),
    building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            info = build_all([name])[name]
            lib = ctypes.CDLL(info["path"])
            _declare(lib, name)
            _LIBS[name] = lib
        return lib
