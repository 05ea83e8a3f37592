"""The device mesh (the port of ``bodywork_tpu.parallel.mesh``).

A single-controller mesh, as JAX's is: one process holds a ``(data,
model)`` grid of ``torch.device``s and every shard is a separate tensor
on its grid device. XLA derived the cross-shard sums and concatenations
from JAX's shardings; here they are written out
(:mod:`bodywork_tpu_torch.parallel.collectives`).

Axis convention: ``data`` (batch parallel) x ``model`` (tensor parallel).

**Virtual devices.** The grid may name one device more than once, the
counterpart of the CPU devices XLA's
``--xla_force_host_platform_device_count`` makes: each shard is still a
separate tensor and a separate launch, on the same device. The device
list the CLI and the stage paths see (:func:`available_devices`) is the
process's cards (``torch.cuda.device_count()``), or the CPU, each
repeated :data:`VIRTUAL_DEVICES_ENV` times (default 1). The variable
changes how many shards go on a device, never which device runs.

**Processes.** :func:`multihost_init` joins a ``torch.distributed``
group from the env names the JAX function reads. The mesh then spans the
group: its data axis is laid out process-major (process *p* owns data
rows ``p*k .. p*k+k-1``) and the model axis stays inside one process, as
a slice's ICI carries it; a mesh whose model axis would cross processes
is refused. A process holds only its own rows of the grid.
"""
from __future__ import annotations

import os

import torch

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("parallel.mesh")

#: how many times each device repeats in :func:`available_devices`
VIRTUAL_DEVICES_ENV = "BODYWORK_TPU_VIRTUAL_DEVICES"


def _virtual_count() -> int:
    raw = os.environ.get(VIRTUAL_DEVICES_ENV, "").strip()
    if not raw:
        return 1
    try:
        count = int(raw)
    except ValueError:
        count = 0
    if count < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV} must be a positive integer, got {raw!r}")
    return count


def available_devices(device=None) -> list[torch.device]:
    """This process's devices as a mesh sees them: every card when
    ``device`` is a CUDA one (the default; no CUDA raises), else the CPU,
    each repeated :data:`VIRTUAL_DEVICES_ENV` times, a card's repeats
    side by side."""
    from bodywork_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    n = _virtual_count()
    return [d for d in cards for _ in range(n)]


def _distributed_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_layout() -> tuple[int, int]:
    """``(process index, process count)``: ``(0, 1)`` outside a group."""
    if not _distributed_initialized():
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


class Mesh:
    """A ``(data, model)`` grid of devices. ``devices`` holds this
    process's rows of the grid (all of them in a single process);
    ``shape`` is the whole mesh's, ``{"data": D, "model": M}``;
    ``group`` is the process group the data axis spans, or None;
    ``data_offset`` is the index of this process's first data row."""

    def __init__(self, devices, shape: dict, group=None, data_offset: int = 0):
        self.devices = tuple(tuple(row) for row in devices)
        self.shape = {"data": int(shape["data"]), "model": int(shape["model"])}
        self.group = group
        self.data_offset = data_offset

    @property
    def label(self) -> str:
        return f"{self.shape['data']}x{self.shape['model']}"

    @property
    def lead(self) -> torch.device:
        """The device of this process's first shard."""
        return self.devices[0][0]

    def flat(self) -> list[torch.device]:
        return [d for row in self.devices for d in row]

    def device_ids(self) -> tuple:
        """The grid's devices as hashable ids, in grid order (a cache key)."""
        return tuple((d.type, d.index) for d in self.flat())

    def one_device(self) -> bool:
        """Whether every shard of this process lies on one device."""
        return len(set(self.flat())) == 1


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (default
    :func:`available_devices`), JAX's defaults: all devices on the
    ``data`` axis. In a process group ``devices`` are this process's and
    the mesh spans every process's, data rows process-major."""
    devices = list(devices if devices is not None else available_devices())
    rank, world = process_layout()
    n = len(devices) * world
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if data % world:
        raise ValueError(
            f"mesh {data}x{model} over {world} processes would split the model axis "
            "across processes; the data axis must be a multiple of the process count"
        )
    rows = data // world
    grid = [devices[r * model:(r + 1) * model] for r in range(rows)]
    group = None
    if world > 1:
        import torch.distributed as dist

        group = dist.group.WORLD
    mesh = Mesh(grid, {"data": data, "model": model}, group, data_offset=rank * rows)
    repeats = _virtual_count()
    virtual = (f", {repeats} virtual per device ({VIRTUAL_DEVICES_ENV})"
               if repeats > 1 else "")
    log.info(f"mesh data={data} model={model} over {n} {devices[0].type} "
             f"device(s){virtual}")
    _record_mesh_info(data, model)
    return mesh


def _record_mesh_info(data: int, model: int) -> None:
    """One ``_info`` gauge sample per (data, model) shape built by this
    process, so a scrape answers which mesh the process runs."""
    from bodywork_tpu_torch.obs import get_registry

    get_registry().gauge(
        "bodywork_tpu_parallel_mesh_info",
        "Device-mesh topology in use: one sample per (data, model) mesh "
        "shape built by this process (value is always 1)",
    ).set(1.0, data=str(data), model=str(model))


def split_devices(n_groups: int, devices=None) -> list[list]:
    """Partition devices into disjoint equal contiguous groups (the A/B
    pipelines' device isolation, BASELINE.json config 5)."""
    devices = list(devices if devices is not None else available_devices())
    n = len(devices)
    if n % n_groups != 0:
        raise ValueError(f"cannot split {n} devices into {n_groups} equal groups")
    per = n // n_groups
    return [devices[i * per:(i + 1) * per] for i in range(n_groups)]


def multihost_shutdown() -> bool:
    """Leave the process group if this process joined one (the paired
    exit of :func:`multihost_init`). Idempotent: False when there is no
    group."""
    if not _distributed_initialized():
        return False
    import torch.distributed as dist

    dist.destroy_process_group()
    log.info("left the distributed cluster")
    return True


def multihost_init(device=None) -> bool:
    """Join a ``torch.distributed`` group when the coordinator env names
    one; a no-op (False) on a single host. The names are the JAX
    function's: ``COORDINATOR_ADDRESS`` or ``JAX_COORDINATOR_ADDRESS``
    (``host:port``), ``NUM_PROCESSES`` or ``JAX_NUM_PROCESSES``, and
    ``PROCESS_ID``, ``JAX_PROCESS_ID`` or ``JOB_COMPLETION_INDEX`` (set in
    every Indexed-Job pod the emitted manifests run). The backend is NCCL
    for a CUDA ``device`` (the default) and gloo for the CPU. Idempotent:
    a second call in a joined process returns True and joins nothing."""
    addr = os.environ.get("COORDINATOR_ADDRESS") or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return False
    if _distributed_initialized():
        return True
    from bodywork_tpu_torch.device import resolve_device

    n_proc = os.environ.get("NUM_PROCESSES") or os.environ.get("JAX_NUM_PROCESSES")
    proc_id = (os.environ.get("PROCESS_ID") or os.environ.get("JAX_PROCESS_ID")
               or os.environ.get("JOB_COMPLETION_INDEX"))
    if n_proc is None or proc_id is None:
        raise ValueError(
            f"coordinator {addr} is set but the process topology is not: set "
            "NUM_PROCESSES and PROCESS_ID (or JOB_COMPLETION_INDEX)"
        )
    import torch.distributed as dist

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=int(n_proc), rank=int(proc_id))
    log.info(f"joined distributed cluster: process {dist.get_rank()} / "
             f"{dist.get_world_size()} ({backend})")
    return True
