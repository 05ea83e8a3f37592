"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds, not minutes. Libraries are built at
first use, named by a hash of the source, the shared headers, the flags
and the toolkit's version, so an edited source or header, or another
toolkit, rebuilds and an unchanged one loads the existing
library. Each library is written with a checksum beside it, and one
whose bytes no longer match is built again.

A library is looked for in ``build/torch_kernels/`` at the repository
root (listed in ``.gitignore``; an image's build step fills it) and then
in ``BODYWORK_TPU_COMPILE_CACHE`` (which
``utils/compile_cache.enable_compile_cache`` and the CLI's
``--compile-cache DIR`` set), such as the store volume the daily pods
share; a library in neither is built into the cache, or into
``build/torch_kernels/`` where no cache is set. The variable is read at
each build, not at import. Several processes, on one host or on many,
may build into one directory at once: each writes a temporary file of
its own and renames it into place. Nothing is built or loaded when a
module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import secrets
import shutil
import socket
import subprocess
import threading
import time
from pathlib import Path

from bodywork_tpu_torch.utils.compile_cache import ENV_VAR as COMPILE_CACHE_ENV
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("ops.build")

_CSRC = Path(__file__).resolve().parent / "csrc"

#: kernel library name -> its CUDA source (which may include the headers
#: ``csrc/*.cuh``)
SOURCES = {
    "mlp_kernel": _CSRC / "mlp_kernel.cu",
    "mlp_bf16_tc": _CSRC / "mlp_bf16_tc.cu",
    "mlp_int8": _CSRC / "mlp_int8.cu",
    "train_gemm": _CSRC / "train_gemm.cu",
}

#: where an image's build step puts the libraries, and where they are built
#: when no ``BODYWORK_TPU_COMPILE_CACHE`` is set
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # print each kernel's registers, shared memory and spills into the log
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """The directory a missing library is built into, read at each call:
    ``BODYWORK_TPU_COMPILE_CACHE`` (which every process of a pod
    inherits), else :data:`DEFAULT_BUILD_DIR`. A library already loaded
    stays loaded from where it was found."""
    return Path(os.environ.get(COMPILE_CACHE_ENV) or DEFAULT_BUILD_DIR)


def _cuda_home() -> str | None:
    """The CUDA toolkit's directory, found as ``torch.utils.cpp_extension``
    finds it (``CUDA_HOME`` or ``CUDA_PATH``, else the ``nvcc`` on
    ``PATH``, else ``/usr/local/cuda``), without importing it: a process
    that only loads a library stays quick to start."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home is None:
        nvcc = shutil.which("nvcc")
        home = os.path.dirname(os.path.dirname(nvcc)) if nvcc else "/usr/local/cuda"
    return home if os.path.exists(home) else None


def _nvcc() -> str:
    home = _cuda_home()
    if home is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build with the CUDA "
            "toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return str(Path(home) / "bin" / "nvcc")


@functools.lru_cache(maxsize=1)
def _toolkit() -> str:
    """The toolkit's version, part of every library's name: a cache that
    outlives an image must not hand a library one toolkit built to
    another. The toolkit's ``version.json`` (which names each component's
    version, ``nvcc``'s too), else ``nvcc --version``; empty where there
    is no toolkit (nothing is built there)."""
    try:
        nvcc = Path(_nvcc())
    except RuntimeError:
        return ""
    versions = nvcc.parents[1] / "version.json"
    if versions.exists():
        return versions.read_text()
    return subprocess.run([str(nvcc), "--version"], capture_output=True, text=True,
                          check=True).stdout


def _library_file(name: str) -> str:
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + headers + "\0".join(NVCC_FLAGS).encode()
        + _toolkit().encode()
    ).hexdigest()[:16]
    return f"{name}-{digest}.so"


def _checksum_path(path: Path) -> Path:
    return path.with_suffix(".sha256")


def _intact(path: Path) -> bool:
    """Whether ``path`` holds a library whose bytes match the checksum
    written beside it when it was built."""
    try:
        want = _checksum_path(path).read_text().strip()
        return hashlib.sha256(path.read_bytes()).hexdigest() == want
    except FileNotFoundError:
        return False


def library_path(name: str) -> Path:
    """Where library ``name`` is loaded from: the one in
    :data:`DEFAULT_BUILD_DIR` where an intact one is there (an image's
    prebuilt library), else the one in :func:`build_dir`, which
    :func:`build_all` builds where it is missing or damaged."""
    file = _library_file(name)
    prebuilt = DEFAULT_BUILD_DIR / file
    if build_dir() != DEFAULT_BUILD_DIR and _intact(prebuilt):
        return prebuilt
    return build_dir() / file


def _tmp_name(name: str) -> str:
    """A temporary name for a library being built that no other process
    takes: pods that share a cache directory may run under one PID (each
    container numbers its own processes), so the host name and a random
    suffix join the PID."""
    return f".tmp-{socket.gethostname()}-{os.getpid()}-{secrets.token_hex(4)}-{name}"


def build_all(names=None) -> dict[str, dict]:
    """Compile every named source that has no intact up-to-date library
    (:func:`library_path`) into :func:`build_dir`, one ``nvcc`` process
    per source, all started together. Returns, per
    name, the library path, whether it was built now, the build seconds
    and the compiler's log. Raises ``RuntimeError`` with the log if any
    build fails."""
    names = list(SOURCES) if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    results, procs = {}, {}
    for name in names:
        path = library_path(name)
        if _intact(path):
            log_path = path.with_suffix(".log")
            results[name] = {
                "path": str(path), "built": False, "seconds": 0.0,
                "log": log_path.read_text() if log_path.exists() else "",
            }
            continue
        tmp = path.with_name(_tmp_name(path.name))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (path, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failures = []
    for name, (path, tmp, t0, proc) in procs.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{output}")
            continue
        tmp.with_suffix(".log").write_text(output)
        _checksum_path(tmp).write_text(hashlib.sha256(tmp.read_bytes()).hexdigest() + "\n")
        # each file atomic, the library last: a concurrent loader sees all
        # or nothing of each, and one that reads a checksum of another
        # build's library builds again
        for suffix in (".log", ".sha256", ".so"):
            os.replace(tmp.with_suffix(suffix), path.with_suffix(suffix))
        results[name] = {"path": str(path), "built": True, "seconds": seconds, "log": output}
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
    # (dy, K, N, hi, lo, stream); (h, b_hi, b_lo, c, workspace, M, N, K,
    # splits, stream)
    "train_gemm": {
        "train_gemm_split": ([_P, _I, _I, _P, _P, _P], _I),
        "train_gemm": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "train_gemm_error_string": ([_I], ctypes.c_char_p),
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
            t0 = time.perf_counter()
            info = build_all([name])[name]
            lib = ctypes.CDLL(info["path"])
            log.info(f"kernel library {name}: {'built' if info['built'] else 'loaded'} "
                     f"{info['path']} in {time.perf_counter() - t0:.3f} s")
            _declare(lib, name)
            _LIBS[name] = lib
        return lib
