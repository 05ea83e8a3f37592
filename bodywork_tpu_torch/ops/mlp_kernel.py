"""The fused MLP scoring forward: a hand-written CUDA kernel for Hopper and
its plain PyTorch version (the port of ``bodywork_tpu.ops.mlp_kernel``).

The serving hot path is standardise -> dense/relu stack -> unstandardise.
:func:`fold_scaler_into_net` folds the scaler into the first and last
layers once per model, so the kernel is a pure dense stack:

    W1' = W1 / x_std[:, None],   b1' = b1 - (x_mean / x_std) @ W1
    WL' = WL * y_std,            bL' = bL * y_std + y_mean

:func:`make_kernel_mlp_apply` builds ``apply(X) -> y`` over the folded
layers in one of three weight types — f32 (engine ``kernel``), bf16
(``kernel-bf16``) and symmetric per-output-column int8 (``kernel-int8``),
the counterparts of the Pallas ``pallas``, ``pallas-bf16`` and
``pallas-int8`` engines. For a CUDA tensor ``apply`` launches the
engine's kernel or raises: ``ops/csrc/mlp_kernel.cu`` (f32 products as
three TF32 ``mma.sync`` each), ``ops/csrc/mlp_bf16_tc.cu`` (bf16 on the
tensor cores) or ``ops/csrc/mlp_int8.cu`` (int8 weights, f32 FMA); each
source's header gives its design and bound. All three split every layer's
columns over a thread-block cluster; :func:`launch_plan` picks the row
tile and cluster size per batch. Only a tensor on the CPU takes the plain
version, :func:`mlp_stack_plain`, which computes the same function in
plain torch ops — that is how the CPU tests run, and what
``chip_smoke.py`` holds each kernel against on the card.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import threading
from dataclasses import dataclass

import torch

from bodywork_tpu_torch.device import resolve_device
from bodywork_tpu_torch.models.fused import quantize_int8

#: the default serving bucket row tile (the Pallas ``ROW_TILE``): the
#: kernel predictor's buckets are (tile, 2*tile, 16*tile)
ROW_TILE = 256

#: compute dtype -> serving engine name of its kernel
KERNEL_ENGINES = {None: "kernel", "bfloat16": "kernel-bf16", "int8": "kernel-int8"}

#: engine -> (kernel library, its C entry point)
_ENTRY_POINTS = {
    "kernel": ("mlp_kernel", "mlp_f32_forward"),
    "kernel-bf16": ("mlp_bf16_tc", "mlp_bf16_forward"),
    "kernel-int8": ("mlp_int8", "mlp_int8_forward"),
}

#: launches of each kernel variant since the last :func:`reset_launches`;
#: each wrapper adds one where it launches its kernel, and nowhere else
LAUNCHES = {name: 0 for name in _ENTRY_POINTS}
_LAUNCH_LOCK = threading.Lock()

#: the C entry points take at most MAX_LAYERS layers
MAX_LAYERS = 16


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(engine: str) -> None:
    """Add one launch of ``engine``'s kernel: an eager launch, or a replay
    of a CUDA graph that holds the kernel (``serve.predictor``'s graph
    cache). A capture launches nothing and counts nothing."""
    with _LAUNCH_LOCK:
        LAUNCHES[engine] += 1


def fold_scaler_into_net(params: dict) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Fold the standardisation scaler into the dense stack's first and
    last layers; returns [(W, b), ...] equivalent to ``mlp_apply``."""
    s = params["scaler"]
    layers = [(layer["w"], layer["b"]) for layer in params["net"]["layers"]]
    w1, b1 = layers[0]
    inv = 1.0 / s["x_std"]
    layers[0] = (w1 * inv[:, None], b1 - (s["x_mean"] * inv) @ w1)
    # for a single-layer net layers[-1] IS layers[0], so the y-fold below
    # composes with the x-fold above
    wl, bl = layers[-1]
    layers[-1] = (wl * s["y_std"], bl * s["y_std"] + s["y_mean"])
    return layers


def prepare_layers(folded, compute_dtype: str | None = None) -> list[dict]:
    """Folded (W, b) pairs -> the kernel's layer list: ``w`` in the
    variant's storage type (f32, bf16, or int8 with an f32 ``scale`` per
    output column), ``b`` f32, every tensor contiguous."""
    if compute_dtype not in KERNEL_ENGINES:
        raise ValueError(
            f"unknown kernel compute_dtype {compute_dtype!r}; expected one "
            f"of {list(KERNEL_ENGINES)}"
        )
    layers = []
    for w, b in folded:
        layer = {"b": b.to(torch.float32).contiguous(), "scale": None}
        if compute_dtype == "int8":
            q, scale = quantize_int8(w.detach().cpu().numpy())
            layer["w"] = torch.from_numpy(q).to(w.device)
            layer["scale"] = torch.from_numpy(scale).to(w.device)
        elif compute_dtype == "bfloat16":
            layer["w"] = w.to(torch.bfloat16).contiguous()
        else:
            layer["w"] = w.to(torch.float32).contiguous()
        layers.append(layer)
    return layers


def mlp_stack_plain(layers: list[dict], X: torch.Tensor,
                    compute_dtype: str | None = None) -> torch.Tensor:
    """The kernel's function in plain torch ops: returns column 0 of the
    folded stack's output, (n,) float32. bf16 rounds each layer's input
    activation to bf16 and multiplies in f32 (a bf16 x bf16 product is
    exact in f32); int8 dequantizes ``q * scale`` before an f32 product."""
    h = X.to(torch.float32)
    for i, layer in enumerate(layers):
        if compute_dtype == "int8":
            w = layer["w"].to(torch.float32) * layer["scale"][None, :]
        else:
            w = layer["w"].to(torch.float32)
        if compute_dtype == "bfloat16":
            h = h.to(torch.bfloat16).to(torch.float32)
        h = h @ w + layer["b"]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[:, 0]


@dataclass(frozen=True)
class _Geometry:
    """The shape of one cluster kernel (mirrors the #defines of its
    source): rows per tile, k per ring stage (the first layer's K pads to
    it), columns per unit (every N pads to it), the most units one CTA
    computes per layer, bytes of one activation, shared-memory bytes per
    unit of the CTA's widest slice outside a ring the wrapper sizes,
    fixed bytes (bf16's alignment slack and mbarriers); the ring depths
    the wrapper may pick (empty where the source fixes its ring), the most
    units one such ring stage holds and its bytes per unit;
    ``unit_cost``, the time one more column unit adds to a CTA relative
    to its fixed chain of ring steps, barriers and exchanges (see
    :func:`launch_plan`); and ``full_stages``, whether a stage always
    holds ``stage_units`` units (a narrower slice then takes longer k
    chunks) rather than the CTA's widest slice."""

    rows: int
    k_chunk: int
    unit: int
    max_units: int
    act_bytes: int
    unit_bytes: int
    fixed_bytes: int
    stages: tuple
    stage_units: int
    stage_unit_bytes: int
    unit_cost: float
    full_stages: bool = False


#: the f32 kernel (mlp_kernel.cu: a ring of 2-3 stages, each 16 k-rows of 8
#: units of 64 f32 columns, or as many more k-rows of fewer units), the bf16
#: kernel (mlp_bf16_tc.cu: a ring of 2-6 stages of up to 4 units of 64 x 64
#: bf16) and the int8 kernel (mlp_int8.cu: per unit, its fixed ring of 2
#: stages of 32 x 64 int8 and a 32 x 64 f32 tile). ``unit_cost`` is a two-point fit to the
#: ``timing-launch-plan`` sweep of ``chip_smoke.py`` on an H100 SXM: the
#: one-wave times at 256 rows with 8 and 4 units per CTA (clusters of 2 and
#: 4). f32 took 0.350 and 0.220 ms, 0.0325 ms a unit over a fixed 0.090
#: ms; bf16 took 0.101 and 0.077 ms, 0.0061 ms a unit over a fixed 0.052
#: ms; int8 took 0.380 and 0.251 ms, 0.032 ms a unit over a fixed 0.122 ms.
CLUSTER_KERNELS = {
    "kernel": _Geometry(rows=32, k_chunk=16, unit=64, max_units=8, act_bytes=4,
                        unit_bytes=0, fixed_bytes=0, stages=(2, 3), stage_units=8,
                        stage_unit_bytes=16 * 64 * 4, unit_cost=0.36, full_stages=True),
    "kernel-bf16": _Geometry(rows=64, k_chunk=64, unit=64, max_units=8, act_bytes=2,
                             unit_bytes=0, fixed_bytes=1088, stages=(2, 3, 4, 5, 6),
                             stage_units=4, stage_unit_bytes=64 * 64 * 2, unit_cost=0.12),
    "kernel-int8": _Geometry(rows=32, k_chunk=32, unit=64, max_units=8, act_bytes=4,
                             unit_bytes=2 * 32 * 64 + 32 * 64 * 4, fixed_bytes=0, stages=(),
                             stage_units=0, stage_unit_bytes=0, unit_cost=0.26),
}
#: thread-block cluster sizes the wrapper may launch (above 8 is a
#: non-portable size, allowed on Hopper where the card can schedule it)
CLUSTER_SIZES = (1, 2, 4, 8, 16)


@dataclass(frozen=True)
class LaunchPlan:
    """One launch of a cluster kernel: ``tiles`` row tiles of
    ``rows_per_tile`` rows, each computed by a cluster of ``cluster`` CTAs
    (``grid = tiles * cluster``), each CTA owning at most
    ``units_per_cta`` 64-column units of a layer, with a weight ring of
    ``stages`` stages (0 where the source fixes its ring) and
    ``smem_bytes`` of dynamic shared memory."""

    engine: str
    rows_per_tile: int
    cluster: int
    tiles: int
    grid: int
    units_per_cta: int
    stages: int
    smem_bytes: int


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def padded_widths(widths, engine: str) -> tuple[list[int], list[int]]:
    """Per layer, the padded K and N the cluster kernel of ``engine``
    computes: N to a multiple of the unit, the first K to the ring's k
    chunk, every later K to the previous layer's padded N."""
    geo = CLUSTER_KERNELS[engine]
    n_pad = [_ceil_to(n, geo.unit) for n in widths[1:]]
    k_pad = [_ceil_to(widths[0], geo.k_chunk)] + n_pad[:-1]
    return k_pad, n_pad


def plan_smem_bytes(widths, engine: str, cluster: int, stages: int) -> tuple[int, int]:
    """(dynamic shared memory bytes, most units per CTA) of the cluster
    kernel of ``engine`` at ``cluster`` CTAs a cluster and ``stages`` ring
    stages (0 where the source fixes its ring): the tile's widest padded
    input in the kernel's activation type, plus the ring (and int8's f32
    tile) sized for the CTA's widest column slice, as the source reckons
    it."""
    geo = CLUSTER_KERNELS[engine]
    k_pad, n_pad = padded_widths(widths, engine)
    units = max(-(-(n // geo.unit) // cluster) for n in n_pad)
    stage_units = geo.stage_units if geo.full_stages else min(units, geo.stage_units)
    smem = (geo.fixed_bytes + geo.rows * max(k_pad) * geo.act_bytes
            + units * geo.unit_bytes + stages * stage_units * geo.stage_unit_bytes)
    return smem, units


def launch_plans(widths, n_rows: int, engine: str, n_sms: int, smem_budget: int,
                 clusters: dict | None = None) -> list[LaunchPlan]:
    """Every launch the cluster kernel of ``engine`` can make for an
    ``n_rows`` batch through a stack of ``widths``, smallest cluster first,
    each with the deepest ring that fits. ``clusters`` maps a cluster size
    to how many such clusters the card holds at once (default:
    ``n_sms // size`` for each of :data:`CLUSTER_SIZES`). Raises
    ``ValueError`` where none fits."""
    geo = CLUSTER_KERNELS[engine]
    if clusters is None:
        clusters = {c: n_sms // c for c in CLUSTER_SIZES}
    tiles = -(-n_rows // geo.rows)
    plans = []
    for c in sorted(clusters):
        for stages in sorted(geo.stages, reverse=True) or [0]:
            smem, units = plan_smem_bytes(widths, engine, c, stages)
            if clusters[c] > 0 and units <= geo.max_units and smem <= smem_budget:
                plans.append(LaunchPlan(engine, geo.rows, c, tiles, tiles * c, units,
                                        stages, smem))
                break
    if not plans:
        smem, _ = plan_smem_bytes(widths, engine, max(clusters, default=1),
                                  min(geo.stages, default=0))
        raise ValueError(
            f"{engine}: layer widths up to {max(widths)} need {smem} bytes of shared "
            f"memory per CTA at {geo.rows} rows per tile (or more than "
            f"{geo.max_units} column units per CTA) at every cluster size in "
            f"{sorted(clusters)}; the device allows {smem_budget}"
        )
    return plans


def launch_refusal(widths, engine: str, n_sms: int, smem_budget: int,
                   max_active=None) -> str | None:
    """Why the cluster kernel of ``engine`` cannot launch a stack of
    ``widths`` (input, hidden..., output) on a card with ``n_sms`` SMs and
    ``smem_budget`` bytes of opt-in shared memory a block, or None where
    it can. A plan-time answer: the stack must have at most
    :data:`MAX_LAYERS` layers and fit :func:`launch_plans` (a stack that
    does not, or is no width list at all, gives its reason and never
    raises), and where ``max_active(cluster, smem_bytes)`` is given (the
    card's ``cudaOccupancyMaxActiveClusters`` query,
    :func:`occupancy_query`), at least one fitting plan must be one the
    card can schedule. A query that fails (a negative answer is
    -cudaError) raises: a kernel the card cannot query is broken, which is
    no reason to serve without it."""
    try:
        widths = [int(w) for w in widths]
        if len(widths) < 2 or min(widths) < 1:
            return f"no stack of layers has the widths {widths}"
        if len(widths) - 1 > MAX_LAYERS:
            return f"the kernel takes at most {MAX_LAYERS} layers, got {len(widths) - 1}"
        plans = launch_plans(widths, 1, engine, n_sms, smem_budget)
    except (TypeError, ValueError) as exc:
        return str(exc) or repr(exc)
    if max_active is None:
        return None
    for p in plans:
        n = max_active(p.cluster, p.smem_bytes)
        if n < 0:
            raise RuntimeError(f"{engine}: the occupancy query failed for a cluster of "
                               f"{p.cluster} with {p.smem_bytes} bytes (cudaError {-n})")
        if n > 0:
            return None
    return (f"{engine}: no cluster size in {[p.cluster for p in plans]} can be "
            f"scheduled for layer widths {widths}")


def occupancy_query(engine: str, device=None):
    """``max_active(cluster, smem_bytes)``: how many clusters of the
    kernel of ``engine`` the card (``device``, else the current one)
    holds at once (``cudaOccupancyMaxActiveClusters``). Its first call
    loads the kernel's library, building it where it is not built yet (a
    build failure raises). A failed query raises, naming the CUDA
    error."""
    from bodywork_tpu_torch.ops._build import load_library

    library, entry = _ENTRY_POINTS[engine]
    prefix = entry.rsplit("_", 1)[0]  # mlp_f32 / mlp_bf16 / mlp_int8

    def max_active(cluster: int, smem_bytes: int) -> int:
        lib = load_library(library)
        with torch.cuda.device(device) if device is not None else contextlib.nullcontext():
            n = getattr(lib, f"{prefix}_max_active_clusters")(cluster, smem_bytes)
        if n < 0:
            error = getattr(lib, f"{prefix}_error_string")(-n).decode()
            raise RuntimeError(
                f"{engine}: the occupancy query failed for a cluster of {cluster} with "
                f"{smem_bytes} bytes: {error} (cudaError {-n})"
            )
        return n

    return max_active


def launch_plan(widths, n_rows: int, engine: str, n_sms: int, smem_budget: int,
                clusters: dict | None = None) -> LaunchPlan:
    """The launch for an ``n_rows`` batch, among :func:`launch_plans`.

    - A batch of at most :data:`ROW_TILE` rows (a single request's
      bucket) takes the plan that spreads it over the most CTAs in one
      wave of clusters, so that one request reaches many SMs.
    - A larger batch takes the least reckoned time: waves of clusters
      (``tiles`` over the clusters resident at once) times the time of one
      CTA, ``1 + unit_cost * units_per_cta`` (the engine's fitted
      ``unit_cost``, :data:`CLUSTER_KERNELS`); ties go to the smaller
      cluster.

    Where no plan runs a small batch in one wave, the time decides too."""
    geo = CLUSTER_KERNELS[engine]
    if clusters is None:
        clusters = {c: n_sms // c for c in CLUSTER_SIZES}
    plans = launch_plans(widths, n_rows, engine, n_sms, smem_budget, clusters)

    def waves(p: LaunchPlan) -> int:
        return -(-p.tiles // clusters[p.cluster])

    one_wave = [p for p in plans if waves(p) == 1]
    if n_rows <= ROW_TILE and one_wave:
        return max(one_wave, key=lambda p: p.grid)
    return min(plans, key=lambda p: (waves(p) * (1 + geo.unit_cost * p.units_per_cta),
                                     p.cluster))


def pad_layers(layers: list[dict], engine: str) -> list[dict]:
    """The prepared layers in the layout the cluster kernel of ``engine``
    reads, zero-padded to :func:`padded_widths` (zero padding is exact),
    with ``b`` (N_pad,) f32, zeros past N:

    - bf16: ``w`` is W^T (N_pad, K_pad) cut into tiles of 64 columns x 64
      k, ordered (k chunk, column unit, row, 16-byte chunk, 8 values),
      each 128-byte row already in the 128-byte swizzle (a
      ``(K_pad/64, N_pad/64, 64, 8, 8)`` bf16 tensor);
    - f32 and int8: ``w`` is (K_pad, N_pad) in its own type; int8's
      ``scale`` is (N_pad,) with 1 on padded columns."""
    widths = [layers[0]["w"].shape[0]] + [layer["w"].shape[1] for layer in layers]
    k_pad, n_pad = padded_widths(widths, engine)
    out = []
    for layer, kp, np_ in zip(layers, k_pad, n_pad):
        w = layer["w"]
        k, n = w.shape
        b = torch.zeros(np_, dtype=torch.float32, device=w.device)
        b[:n] = layer["b"]
        padded = {"b": b, "scale": None}
        if engine == "kernel-bf16":
            wt = torch.zeros(np_, kp, dtype=torch.bfloat16, device=w.device)
            wt[:n, :k] = w.t()
            tiles = wt.view(np_ // 64, 64, kp // 64, 8, 8).permute(2, 0, 1, 3, 4)
            # 16-byte chunk c of tile row r goes to position c ^ (r % 8)
            rows = torch.arange(64, device=w.device)[:, None]
            swizzle = torch.arange(8, device=w.device)[None, :] ^ (rows % 8)
            padded["w"] = tiles[:, :, rows, swizzle].contiguous()
        else:
            padded["w"] = torch.zeros(kp, np_, dtype=w.dtype, device=w.device)
            padded["w"][:k, :n] = w
            if layer["scale"] is not None:
                padded["scale"] = torch.ones(np_, dtype=torch.float32, device=w.device)
                padded["scale"][:n] = layer["scale"]
        out.append(padded)
    return out


def _ptrs(tensors) -> ctypes.Array:
    tensors = list(tensors)
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


class _ClusterLaunch:
    """Launch state of an engine's cluster kernel for one prepared
    layer list on one CUDA device: the padded weights and the ctypes
    argument arrays are built once, and each cluster size the card can
    schedule for this stack is found once (``cudaOccupancyMaxActiveClusters``)."""

    def __init__(self, layers: list[dict], engine: str, cluster: int | None):
        from bodywork_tpu_torch.ops._build import load_library

        device = layers[0]["w"].device
        props = torch.cuda.get_device_properties(device)
        self.n_sms = props.multi_processor_count
        self.smem_budget = props.shared_memory_per_block_optin
        self.widths = [layers[0]["w"].shape[0]] + [layer["w"].shape[1] for layer in layers]
        sizes = CLUSTER_SIZES if cluster is None else (cluster,)
        fitting = launch_plans(self.widths, 1, engine, self.n_sms, self.smem_budget,
                               {c: self.n_sms // c for c in sizes})
        library, entry = _ENTRY_POINTS[engine]
        lib = load_library(library)
        prefix = entry.rsplit("_", 1)[0]  # mlp_f32 / mlp_bf16 / mlp_int8
        max_active = occupancy_query(engine)
        #: cluster size -> clusters of it the card holds at once, for this stack
        self.clusters = {}
        for p in fitting:
            n = max_active(p.cluster, p.smem_bytes)
            if n > 0:
                self.clusters[p.cluster] = n
        if not self.clusters:
            raise ValueError(
                f"{engine}: no cluster size in {[p.cluster for p in fitting]} can be "
                f"scheduled for layer widths {self.widths} on {props.name}"
            )
        self.layers = layers
        self.engine = engine
        self.device = device
        k_pad, n_pad = padded_widths(self.widths, engine)
        n = len(layers)
        self._kp = (ctypes.c_int * n)(*k_pad)
        self._np = (ctypes.c_int * n)(*n_pad)
        self._bind(pad_layers(layers, engine))
        self._fn = getattr(lib, entry)
        self._error_string = getattr(lib, f"{prefix}_error_string")
        self._plans: dict[int, LaunchPlan] = {}

    def _bind(self, padded: list[dict]) -> None:
        """Point the launch's argument arrays at ``padded`` weights."""
        self.padded = padded
        self._w = _ptrs(layer["w"] for layer in padded)
        self._b = _ptrs(layer["b"] for layer in padded)
        self._scale = (_ptrs(layer["scale"] for layer in padded)
                       if self.engine == "kernel-int8" else None)

    def rebound(self, padded: list[dict]) -> "_ClusterLaunch":
        """The same launch over other padded weights of the same shapes
        (a CUDA graph's static weight buffers): the plans, the card's
        cluster occupancy and the entry point are shared, and the ctypes
        argument arrays hold the new weights' pointers. A graph captured
        from the result reads those buffers at every replay, whatever
        predictor asks for it, so their owner must copy its own weights
        in first (``serve.predictor``'s graph cache does)."""
        launch = copy.copy(self)
        launch._bind(padded)
        return launch

    def plan(self, n_rows: int) -> LaunchPlan:
        """The launch for an ``n_rows`` batch (:func:`launch_plan` over
        the cluster sizes this card can schedule)."""
        p = self._plans.get(n_rows)
        if p is None:
            p = launch_plan(self.widths, n_rows, self.engine, self.n_sms,
                            self.smem_budget, self.clusters)
            if len(self._plans) < 64:
                self._plans[n_rows] = p
        return p

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        if X.device != self.device:
            raise ValueError(f"input on {X.device}, kernel weights on {self.device}")
        X = X.to(torch.float32).contiguous()
        n = X.shape[0]
        if n >= 2**31:
            raise ValueError(f"{n} rows exceed the kernel's 32-bit row count")
        out = torch.empty(n, dtype=torch.float32, device=X.device)
        plan = self.plan(n)
        stream = torch.cuda.current_stream(X.device).cuda_stream
        # int8 takes its scales; f32 and bf16 their ring depth
        shape = ((self._scale, plan.cluster) if self._scale is not None
                 else (plan.cluster, plan.stages))
        rc = self._fn(
            X.data_ptr(), out.data_ptr(), n, len(self.layers), self.widths[0],
            self._kp, self._np, self._w, self._b, *shape, plan.smem_bytes, stream,
        )
        if rc != 0:
            raise RuntimeError(
                f"{self.engine} kernel launch failed: "
                f"{self._error_string(rc).decode()} (cudaError {rc})"
            )
        # under a CUDA-graph capture nothing runs: the graph's replays count
        if not torch.cuda.is_current_stream_capturing():
            count_launch(self.engine)
        return out


def make_kernel_mlp_apply(params: dict, device=None,
                          compute_dtype: str | None = None,
                          row_tile: int | None = None,
                          block_rows: int | None = None,
                          cluster: int | None = None):
    """Build ``apply(X) -> y`` running the folded MLP through the fused
    kernel (on ``device``: the card unless asked for the CPU).

    ``apply`` takes (n, d) or (n,) input (numpy or torch), raises
    ``ValueError`` on a feature-count mismatch, and returns the (n,)
    regression head, unpadded, as a float32 tensor on ``device``. On a
    CUDA device it launches the kernel; on the CPU it runs
    :func:`mlp_stack_plain`.

    ``row_tile`` is the serving bucket's row tile (default
    :data:`ROW_TILE`, a positive multiple of 8, else ``ValueError``);
    the kernel predictor pads batches to its multiples. The kernel itself
    masks ragged rows and widths, so ``apply`` pads nothing.
    ``block_rows`` can only restate the engine's row tile: 32 rows for
    ``kernel`` and ``kernel-int8``, 64 for ``kernel-bf16`` (``ValueError``
    otherwise). ``cluster`` pins the thread-block cluster size (one of
    :data:`CLUSTER_SIZES`). By default each launch picks it from its batch
    size (:func:`launch_plan`).
    """
    tile = int(row_tile or ROW_TILE)
    if tile < 8 or tile % 8 != 0:
        raise ValueError(f"row_tile must be a positive multiple of 8, got {tile}")
    dev = resolve_device(device)
    engine = KERNEL_ENGINES.get(compute_dtype)
    if engine is not None:
        rows = CLUSTER_KERNELS[engine].rows
        if block_rows not in (None, rows):
            raise ValueError(f"{engine}: block_rows must be {rows}, got {block_rows}")
        if cluster is not None and cluster not in CLUSTER_SIZES:
            raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got {cluster}")
    layers = prepare_layers(
        fold_scaler_into_net(_params_on(params, dev)), compute_dtype
    )
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"the kernel takes at most {MAX_LAYERS} layers, got {len(layers)}")
    d_in = layers[0]["w"].shape[0]
    launch = _ClusterLaunch(layers, engine, cluster) if dev.type == "cuda" else None

    def apply(X) -> torch.Tensor:
        if isinstance(X, torch.Tensor) and X.device.type != dev.type:
            # never move a tensor to another kind of device behind the
            # caller's back: a CUDA tensor launches the kernel or raises
            raise ValueError(f"input on {X.device}, the kernel serves {dev}")
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        if X.ndim == 1:
            X = X[:, None]
        if X.shape[1] != d_in:
            # zero-filling a short row would silently score garbage; the
            # torch engine raises on a feature-count mismatch too
            raise ValueError(f"expected {d_in} feature(s), got {X.shape[1]}")
        if X.is_cuda:
            return launch(X)
        return mlp_stack_plain(layers, X, compute_dtype)

    apply.engine = engine
    apply.layers = layers
    apply.row_tile = tile
    apply.launch = launch
    return apply


def _params_on(params, device):
    if isinstance(params, dict):
        return {k: _params_on(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_params_on(v, device) for v in params]
    return params.detach().to(device=device, dtype=torch.float32)
