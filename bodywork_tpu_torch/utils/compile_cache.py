"""The kernel-library cache (the port of ``bodywork_tpu.utils.compile_cache``).

The JAX package points XLA's persistent compilation cache at a stable
path, because each daily k8s stage is a fresh one-shot pod that would
otherwise pay every compile again. The port's compiled artefacts are its
``nvcc`` libraries (``ops/_build.py``), keyed by a hash of their sources
and flags. By default they are written beside the package
(``build/torch_kernels/``); a pod whose package directory is read-only,
or whose image was built without the prebuild step, would run ``nvcc``
again in every pod of every day. Pointing the cache at the shared store
volume lets today's pod load what yesterday's built. A library the image
already holds (its build step fills ``build/torch_kernels/``) is still
loaded from the image: the cache only takes what the image lacks. The
libraries' names carry the toolkit's version, so images of two toolkits
can share one cache.

Resolution order: explicit path > ``BODYWORK_TPU_COMPILE_CACHE`` env >
disabled (the default build directory). ``ops/_build.py`` reads the
variable itself at each build, so a pod's child processes (spawned
workers, the dispatcher) use the cache too, as every JAX process reads
XLA's cache variable. The JAX function's ``min_compile_time_s`` has no
counterpart: every ``nvcc`` build is worth keeping.
"""
from __future__ import annotations

import os

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("utils.compile_cache")

ENV_VAR = "BODYWORK_TPU_COMPILE_CACHE"


def enable_compile_cache(path: str | None = None) -> str | None:
    """Point the kernel builds of this process, and of every process it
    starts, at ``path`` and return the resolved path (``None`` =
    disabled, nothing touched).

    ``ops/_build.py`` reads :data:`ENV_VAR` at each build, so this sets
    it; nothing of ``ops`` (or torch) is imported here, and a process
    that never builds a kernel (the test stage's pod) stays torch-free.
    Must run before the first kernel library is loaded: a library already
    loaded stays where it was built."""
    path = path or os.environ.get(ENV_VAR)
    if not path:
        return None
    os.makedirs(path, exist_ok=True)
    os.environ[ENV_VAR] = str(path)
    log.info(f"kernel library cache at {path}")
    return str(path)
