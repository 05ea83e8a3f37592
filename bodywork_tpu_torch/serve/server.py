"""Scoring-service lifecycle (the port of ``bodywork_tpu.serve.server``).

:func:`serve_latest_model` loads the checkpoint to serve (the registry's
``production`` alias, or the newest checkpoint on a store without one)
onto the card and hands it to :func:`serve_model`, which picks the engine,
warms every bucket (capturing its CUDA graph, ``serve.predictor``) and
serves over one of the :data:`SERVER_ENGINES`: ``thread``
(``http.server.ThreadingHTTPServer``, one thread per connection) or
``aio`` (the asyncio front end, ``serve.aio``). The day loop's serve
stage calls :func:`serve_model` itself; with ``block=False`` they return
a started handle. With ``replicas > 1`` the requests alternate over N
scoring apps that share one predictor (:class:`RoundRobinApp`).

``batch_window_ms`` > 0 puts a request coalescer (``serve.batcher``) in
front of each app; ``max_pending`` arms admission control
(``serve.admission``), which the ``aio`` engine arms by default;
``watch_interval_s`` hot-swaps newer checkpoints into the running
service (``serve.reload``), with the SLO watchdog judging a live canary
on its polls. A blocking service that receives SIGTERM (``cli serve``)
closes admission, then stops: the watcher joined, the coalescers
flushed.

Engine names map one to one onto the JAX package's (:data:`ENGINE_NAMES`):
``xla*`` -> ``torch*`` (plain torch in f32, bf16 or from int8 weights),
``pallas*`` -> ``kernel*`` (the fused CUDA kernel in f32, bf16 or int8).

A serving dtype (``serve --dtype bfloat16|int8``) picks the quantized
variant of the resolved engine (:func:`quantized_engine_for`: ``torch`` ->
``torch-bf16|int8``, ``kernel`` -> ``kernel-bf16|int8``), which serves only
after the shadow quality gate admits it against the f32 predictions of
the same checkpoint (:func:`build_serving_predictor`); otherwise f32
keeps serving, and ``/healthz`` says which dtype serves.
"""
from __future__ import annotations

import itertools
import threading

import torch

from bodywork_tpu_torch.device import require_ieee_f32_matmul, resolve_device
from bodywork_tpu_torch.models.checkpoint import load_model, resolve_serving_key
from bodywork_tpu_torch.models.mlp import MLPRegressor
from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.serve.admission import build_admission
from bodywork_tpu_torch.serve.app import create_app
from bodywork_tpu_torch.serve.httpcore import LocalClient, ServiceHandle
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.utils.logging import get_logger
from bodywork_tpu_torch.utils.shutdown import ShutdownRequested

log = get_logger("serve.server")

#: the HTTP front ends: ``thread`` (one thread per connection, default)
#: and ``aio`` (the asyncio event loop, ``serve.aio``); the JAX package's
SERVER_ENGINES = ("thread", "aio")

#: JAX engine name -> the port's engine name
ENGINE_NAMES = {
    "xla": "torch",
    "xla-bf16": "torch-bf16",
    "xla-int8": "torch-int8",
    "pallas": "kernel",
    "pallas-bf16": "kernel-bf16",
    "pallas-int8": "kernel-int8",
}

_KERNEL_DTYPES = {"kernel": None, "kernel-bf16": "bfloat16", "kernel-int8": "int8"}

#: minimum hidden width at which ``engine="auto"`` picks the kernel. This
#: is the JAX package's cut (``PALLAS_AUTO_MIN_WIDTH``), a TPU v5e
#: measurement; it stands until the card's own width sweep sets one.
KERNEL_AUTO_MIN_WIDTH = 256


def resolve_engine(engine: str, model, device, n_sms: int | None = None,
                   smem_budget: int | None = None, max_active=None,
                   mesh_data: int | None = None, mesh_model: int = 1) -> str:
    """Resolve ``engine="auto"``: on a CUDA device, the fused f32 kernel
    for an MLP whose narrowest hidden layer is at least
    :data:`KERNEL_AUTO_MIN_WIDTH` wide and that the kernel can launch;
    the plain ``torch`` engine otherwise, and always over a device mesh
    (``mesh_data`` / ``mesh_model`` > 1: the kernel is single-device).
    Explicit engine choices pass through untouched (and a kernel that
    cannot launch the model raises when the predictor is built).

    Whether the kernel can launch is a plan-time question
    (:func:`~bodywork_tpu_torch.ops.mlp_kernel.launch_refusal`): the
    layer cap, the card's SM count and opt-in shared memory a block
    (``n_sms`` / ``smem_budget``, read from the device when not given),
    and the card's cluster occupancy query (``max_active``, the built
    kernel's own when not given). A refusal is logged with its reason."""
    if engine != "auto":
        return engine
    if _use_mesh(mesh_data, mesh_model):
        return "torch"  # the kernel is single-device; the mesh path is plain torch
    if not isinstance(model, MLPRegressor) or device.type != "cuda":
        return "torch"
    layers = model.net.layers
    widths = [layers[0].w.shape[0]] + [layer.w.shape[1] for layer in layers]
    if min(widths[1:-1], default=0) < KERNEL_AUTO_MIN_WIDTH:
        return "torch"
    from bodywork_tpu_torch.ops.mlp_kernel import launch_refusal, occupancy_query

    if n_sms is None or smem_budget is None:
        props = torch.cuda.get_device_properties(device)
        n_sms = props.multi_processor_count if n_sms is None else n_sms
        if smem_budget is None:
            smem_budget = props.shared_memory_per_block_optin
    reason = launch_refusal(widths, "kernel", n_sms, smem_budget,
                            max_active or occupancy_query("kernel", device))
    if reason is not None:
        log.warning(f"auto: the f32 kernel cannot launch {model.info} "
                    f"({reason}); serving through the torch engine")
        return "torch"
    return "kernel"


def _use_mesh(mesh_data: int | None, mesh_model: int) -> bool:
    return bool(mesh_data and mesh_data > 1) or mesh_model > 1


def _mesh_predictor(model, mesh_data: int | None, mesh_model: int,
                    buckets: tuple[int, ...] | None):
    """The predictor over a ``data x model`` mesh of the model's kind of
    device: an MLP Megatron-sharded (``parallel.ShardedMLPPredictor``),
    anything else data-parallel. The knobs are fleet-wide env settings, so
    a model axis over a checkpoint that is not an MLP, and a mesh larger
    than the devices, degrade with a warning rather than crash-loop a
    pod."""
    from bodywork_tpu_torch.parallel import DataParallelPredictor, ShardedMLPPredictor, make_mesh
    from bodywork_tpu_torch.parallel.mesh import available_devices

    data = mesh_data if mesh_data and mesh_data > 1 else 1
    model_axis = mesh_model
    if model_axis > 1 and not isinstance(model, MLPRegressor):
        log.warning(f"mesh_model={model_axis} requires an MLP checkpoint; serving "
                    f"{model.info} data-parallel over {data} device(s) instead")
        model_axis = 1
    devices = available_devices(model.device)
    if data * model_axis > len(devices):
        requested = f"{data}x{model_axis}"
        if model_axis > len(devices):
            model_axis = 1
        data = max(len(devices) // model_axis, 1)
        log.warning(f"mesh {requested} needs more than the {len(devices)} available "
                    f"device(s); serving {data}x{model_axis} instead")
    mesh = make_mesh(data=data, model=model_axis, devices=devices[:data * model_axis])
    if isinstance(model, MLPRegressor):
        return ShardedMLPPredictor(model, mesh, buckets=buckets)
    return DataParallelPredictor(model, mesh, buckets=buckets)


def build_predictor(model, engine: str = "auto",
                    buckets: tuple[int, ...] | None = None,
                    mesh_data: int | None = None, mesh_model: int = 1):
    """The predictor for an engine choice (``auto`` resolved against the
    model's device). The quantized engines refuse a model that is not an
    MLP with ``ValueError``. ``mesh_data`` / ``mesh_model`` > 1 serve
    through the plain engine over a device mesh (:func:`_mesh_predictor`);
    the kernel and quantized engines, single-device, refuse one."""
    from bodywork_tpu_torch.serve.predictor import (
        DEFAULT_BUCKETS,
        BF16MLPPredictor,
        Int8MLPPredictor,
        KernelMLPPredictor,
        PaddedPredictor,
    )

    engine = resolve_engine(engine, model, model.device, mesh_data=mesh_data,
                            mesh_model=mesh_model)
    if _use_mesh(mesh_data, mesh_model) and engine in ENGINE_NAMES.values():
        if engine != "torch":
            raise ValueError(f"engine={engine!r} is single-device; drop --mesh-data/"
                             "--mesh-model")
        return _mesh_predictor(model, mesh_data, mesh_model, buckets)
    if engine in _KERNEL_DTYPES:
        return KernelMLPPredictor(model, buckets, compute_dtype=_KERNEL_DTYPES[engine])
    if engine == "torch":
        require_ieee_f32_matmul(model.device)
        return PaddedPredictor(model, buckets or DEFAULT_BUCKETS)
    if engine == "torch-bf16":
        return BF16MLPPredictor(model, buckets)
    if engine == "torch-int8":
        return Int8MLPPredictor(model, buckets)
    raise ValueError(
        f"unknown serving engine {engine!r}; expected 'auto' or one of "
        f"{sorted(set(ENGINE_NAMES.values()))}"
    )


def _count_quantization_gate(dtype: str, outcome: str) -> None:
    reg = get_registry()
    reg.counter(
        "bodywork_tpu_serve_quantization_gate_total",
        "Quantized-serving shadow-gate verdicts at boot/swap, by dtype "
        "and outcome (served|rejected_quality|no_shadow_data|"
        "unsupported_model|unsupported_mesh)",
    ).inc(dtype=dtype, outcome=outcome)
    reg.gauge(
        "bodywork_tpu_serve_quantized_state",
        "Quantized serving: 0=f32 default, 1=quantized dtype serving, "
        "2=quantized requested but f32 kept (gate/unsupported)",
        aggregate="max",
    ).set(1.0 if outcome == "served" else 2.0)


#: (base engine, serving dtype) -> the engine that implements it
_QUANTIZED_VARIANTS = {
    ("torch", "bfloat16"): "torch-bf16",
    ("torch", "int8"): "torch-int8",
    ("kernel", "bfloat16"): "kernel-bf16",
    ("kernel", "int8"): "kernel-int8",
}


def quantized_engine_for(engine: str, dtype: str) -> str:
    """Map a (resolved base engine, serving dtype) pair onto the engine
    variant that implements it (``torch`` + int8 -> ``torch-int8``,
    ``kernel`` + bfloat16 -> ``kernel-bf16``, ...; float32 keeps the
    engine). An explicit quantized engine may not be combined with a
    contradicting dtype (``bodywork_tpu/serve/server.py:165-202``)."""
    from bodywork_tpu_torch.serve.predictor import SERVE_DTYPES

    if dtype not in SERVE_DTYPES:
        raise ValueError(f"unknown serving dtype {dtype!r}; expected one of {SERVE_DTYPES}")
    if dtype == "float32":
        return engine
    if engine in _QUANTIZED_VARIANTS.values():
        implied = "bfloat16" if engine.endswith("bf16") else "int8"
        if implied != dtype:
            raise ValueError(f"--engine {engine} contradicts --dtype {dtype}")
        return engine
    variant = _QUANTIZED_VARIANTS.get((engine, dtype))
    if variant is None:
        raise ValueError(f"engine {engine!r} has no {dtype} variant; use engine "
                         "'torch' or 'kernel' with --dtype")
    return variant


def build_serving_predictor(store, model, engine: str = "auto",
                            buckets: tuple[int, ...] | None = None,
                            dtype: str = "float32", policy=None,
                            mesh_data: int | None = None, mesh_model: int = 1):
    """The predictor serving runs for an (engine, dtype) choice, and the
    dtype that serves: ``(predictor, served_dtype)``.

    float32 is :func:`build_predictor`. A quantized dtype builds the f32
    predictor of the resolved engine and its quantized variant, scores
    both over the store's last ``policy.quantized_shadow_days`` dataset
    days (``registry.shadow.shadow_compare``) and holds the delta to the
    gate's ceilings (``registry.gates.evaluate_quantization``). f32 keeps
    serving (``served_dtype="float32"``), with the outcome logged, when
    the variant fails the gate (``rejected_quality``), when the store has
    no dataset to shadow over (``no_shadow_data``) or when the model has
    no such variant (``unsupported_model``, a ``ValueError`` building
    it). A kernel that fails to build or launch raises. Over a device
    mesh (``mesh_data`` / ``mesh_model``) a quantized dtype keeps f32
    serving over the mesh (``unsupported_mesh``): the quantized engines
    are single-device, and the mesh is the capacity knob."""
    if dtype in (None, "float32"):
        return build_predictor(model, engine, buckets=buckets, mesh_data=mesh_data,
                               mesh_model=mesh_model), "float32"
    if _use_mesh(mesh_data, mesh_model):
        log.warning(f"dtype={dtype} is single-device; keeping f32 serving over the "
                    f"{mesh_data or 1}x{mesh_model} mesh (quantization gate "
                    "outcome=unsupported_mesh)")
        _count_quantization_gate(dtype, "unsupported_mesh")
        return build_predictor(model, engine, buckets=buckets, mesh_data=mesh_data,
                               mesh_model=mesh_model), "float32"
    from bodywork_tpu_torch.registry.gates import GatePolicy, evaluate_quantization
    from bodywork_tpu_torch.registry.shadow import shadow_compare

    policy = policy or GatePolicy()
    base_engine = resolve_engine(engine, model, model.device)
    quant_engine = quantized_engine_for(base_engine, dtype)
    # the f32 baseline: the gate's reference, and what serves on a refusal
    f32_engine = "kernel" if base_engine.startswith("kernel") else "torch"
    f32_predictor = build_predictor(model, f32_engine, buckets=buckets)
    try:
        quant_predictor = build_predictor(model, quant_engine, buckets=buckets)
    except ValueError as exc:
        # e.g. a linear checkpoint under a fleet-wide --dtype int8: keep f32
        log.warning(f"dtype={dtype} unavailable for this checkpoint ({exc}); "
                    "keeping f32 serving (quantization gate outcome=unsupported_model)")
        _count_quantization_gate(dtype, "unsupported_model")
        return f32_predictor, "float32"
    try:
        report = shadow_compare(store, quant_predictor.predict, f32_predictor.predict,
                                days=policy.quantized_shadow_days)
    except ValueError as exc:
        if "no dataset history" not in str(exc):
            raise
        log.warning(f"dtype={dtype}: no dataset history to shadow the quantized variant "
                    "over; keeping f32 serving (quantization gate outcome=no_shadow_data)")
        _count_quantization_gate(dtype, "no_shadow_data")
        return f32_predictor, "float32"
    ok, detail = evaluate_quantization(report, policy)
    if not ok:
        log.warning(f"dtype={dtype} REJECTED by the shadow quality gate ({detail}); keeping "
                    "f32 serving (quantization gate outcome=rejected_quality)")
        _count_quantization_gate(dtype, "rejected_quality")
        return f32_predictor, "float32"
    log.info(f"dtype={dtype} admitted by the shadow quality gate ({detail}) "
             f"(quantization gate outcome=served)")
    _count_quantization_gate(dtype, "served")
    return quant_predictor, dtype


class RoundRobinApp:
    """A front alternating requests over N replica apps (the port of the
    JAX ``RoundRobinApp``): the local stand-in for a k8s Service over the
    reference's 2 replicas (``bodywork.yaml:40-42``). Replicas are
    stateless over read-only model state, so any of them serves a request
    identically; the front makes every replica take traffic."""

    def __init__(self, apps):
        if not apps:
            raise ValueError("need at least one replica app")
        self.apps = list(apps)
        self._counter = itertools.count()
        self._lock = threading.Lock()

    @property
    def predictor(self):
        return self.apps[0].predictor

    def healthz_payload(self) -> dict:
        return self.apps[0].healthz_payload()

    def handle(self, method: str, path: str, body: bytes = b"",
               content_type: str | None = None, **request):
        """``ScoringApp.handle`` on the next replica; the request's other
        fields (``traceparent``) pass through unchanged."""
        with self._lock:
            app = self.apps[next(self._counter) % len(self.apps)]
        return app.handle(method, path, body, content_type, **request)

    def test_client(self) -> LocalClient:
        """An in-process client over the front (what ``InProcessScoringClient``
        and the JAX front's werkzeug client do)."""
        return LocalClient(self)


def registry_bounds(store, key: str | None):
    """The prediction-sanity band of a checkpoint's registry record, or
    None (no key, no record, or an unreadable registry: the band is an
    enhancement and never blocks a start)."""
    if key is None:
        return None
    try:
        from bodywork_tpu_torch.registry.records import load_record

        return (load_record(store, key) or {}).get("prediction_bounds")
    except Exception:  # noqa: BLE001
        return None


def _arm_cost_shed(store, admission, model, buckets, budget_s: float) -> None:
    """Arm ``admission``'s cost-priced shed from the latest learned cost
    model under ``tuning/``: each request priced as the ladder rung it
    pads to, before any parse-side queueing. With no readable cost model
    admission stays count-only, with a warning."""
    from bodywork_tpu_torch.tune.costmodel import cost_pricer, load_cost_model

    doc, digest = load_cost_model(store, "latest")
    if doc is None:
        log.warning("cost-priced shed requested but no cost model is readable under "
                    "tuning/; admission stays count-only")
        return
    admission.configure_cost_shed(
        cost_pricer(doc, model.n_features or 1, buckets=buckets), budget_s)
    log.info(f"cost-priced shed armed (model {digest[:23]}..., budget {budget_s}s)")


def serve_model(model, model_date=None, host: str = "0.0.0.0", port: int = 5000,
                block: bool = True, engine: str = "auto",
                buckets: tuple[int, ...] | None = None, replicas: int = 1,
                model_key: str | None = None, model_source: str | None = None,
                model_bounds=None, dtype: str = "float32", store=None,
                batch_window_ms: float | None = None, batch_max_rows: int | None = None,
                server_engine: str = "thread", max_pending: int | None = None,
                retry_after_max_s: float | None = None,
                watch_interval_s: float | None = None, device=None,
                tuned_config: str | None = None, online_tune: bool = False,
                tune_request_logs: tuple = (), tune_results_logs: tuple = (),
                cost_budget_s: float | None = None, sock=None, shared_slot=None,
                metrics_dir: str | None = None, mesh_data: int | None = None,
                mesh_model: int = 1):
    """Serve a loaded model from its device: build the predictor for the
    engine and dtype (:func:`build_serving_predictor`; a quantized dtype
    shadows over ``store``'s datasets), warm every bucket (a capture or a
    launch that fails fails the start, not a request), and serve through
    ``replicas`` scoring apps that share the predictor, each behind the
    prediction-sanity firewall with ``model_bounds`` as its band.

    ``server_engine`` picks the front end (:data:`SERVER_ENGINES`);
    ``batch_window_ms`` > 0 gives each app a request coalescer flushing at
    ``batch_max_rows``; ``max_pending`` arms admission control, one
    controller shared by the apps (the ``aio`` engine arms it at
    ``DEFAULT_MAX_PENDING`` by default); ``retry_after_max_s`` caps its
    ``Retry-After``. ``watch_interval_s`` starts a checkpoint watcher on
    ``store`` (``serve.reload``, with the SLO watchdog on its polls) that
    hot-swaps the checkpoint serving should run; with it, ``model=None``
    boots a service that answers 503 until the first checkpoint lands
    (loaded onto ``device``). With ``block=False`` returns a started
    handle (``handle.watcher`` is the watcher or None); a blocking
    service leaves on SIGTERM (``ShutdownRequested``) by closing
    admission, then stopping: the watcher joined, the coalescers
    flushed.

    ``tuned_config`` names a tuned serving-config document in ``store``
    (a ``tuning/`` key or ``"latest"``, ``cli tune``'s output): its
    fitted values fill every knob the caller left unset (window, max
    rows, buckets, ``max_pending``, which then arms admission on either
    engine), resolved before any predictor is built; a missing or
    malformed document degrades to the built-in defaults with a warning
    (``tune.config.resolve_serving_knobs``), and the applied digest
    rides ``/healthz`` ``effective_config.tuned_config``.
    ``cost_budget_s`` arms admission's cost-priced shed from the latest
    learned cost model under ``tuning/``, when one is readable.
    ``online_tune`` arms the online re-tune controller (``tune.online``)
    on the watcher's polls, watching ``tune_request_logs`` /
    ``tune_results_logs``; it needs ``watch_interval_s``, and without it
    logs a warning.

    A ``serve --workers`` replica (``serve.multiproc``) passes ``sock``
    (its bound ``SO_REUSEPORT`` socket, listened on instead of
    ``host:port``), ``shared_slot`` (its slot of the service-wide
    admission budget, ``serve.admission.SharedBudgetSlot``) and
    ``metrics_dir`` (the shared snapshot directory ``/metrics`` merges).

    ``mesh_data`` / ``mesh_model`` > 1 serve through a sharded predictor
    over a ``data x model`` device mesh (:func:`build_predictor`), and a
    hot swap re-places the new checkpoint over the same mesh."""
    if server_engine not in SERVER_ENGINES:
        raise ValueError(f"unknown server engine {server_engine!r}; "
                         f"expected one of {SERVER_ENGINES}")
    # the tuned knobs resolve before any predictor or app is built, so
    # they flow into the same plumbing explicit values do
    tuned_digest = None
    if tuned_config:
        from bodywork_tpu_torch.tune.config import resolve_serving_knobs

        resolved = resolve_serving_knobs(
            store, tuned_config, batch_window_ms=batch_window_ms,
            batch_max_rows=batch_max_rows, buckets=buckets, max_pending=max_pending)
        batch_window_ms = resolved.batch_window_ms
        batch_max_rows = resolved.batch_max_rows
        buckets = resolved.buckets
        max_pending = resolved.max_pending
        tuned_digest = resolved.tuned_digest
    if dtype not in (None, "float32") and store is None:
        raise ValueError(f"dtype={dtype} needs the store whose datasets its shadow "
                         "gate scores")
    if watch_interval_s and store is None:
        raise ValueError("a checkpoint watcher needs the store it polls")
    if model is None and not watch_interval_s:
        raise ValueError("nothing to serve: no model and no checkpoint watcher")
    predictor = None
    if model is not None:
        predictor, served_dtype = build_serving_predictor(store, model, engine,
                                                          buckets=buckets, dtype=dtype,
                                                          mesh_data=mesh_data,
                                                          mesh_model=mesh_model)
        log.info(f"serving {model.info} on {model.device} through engine "
                 f"{predictor.engine!r} in {served_dtype} ({max(replicas, 1)} "
                 f"replica(s), {server_engine} front end)")
    admission = build_admission(server_engine, max_pending, retry_after_max_s,
                                shared_slot=shared_slot)
    apps = [
        create_app(model, model_date, predictor=predictor, warmup=False,
                   batch_window_ms=batch_window_ms, batch_max_rows=batch_max_rows,
                   model_key=model_key, model_source=model_source, admission=admission,
                   model_bounds=model_bounds, metrics_dir=metrics_dir)
        for _ in range(max(replicas, 1))
    ]
    for app in apps:
        app.tuned_config_digest = tuned_digest
    if cost_budget_s and admission is not None and model is not None:
        _arm_cost_shed(store, admission, model, buckets, cost_budget_s)
    watcher = None
    try:
        if predictor is not None:
            predictor.warmup()
        if server_engine == "aio":
            from bodywork_tpu_torch.serve.aio import AioServiceHandle

            handle = AioServiceHandle(apps, host, port, sock=sock)
        else:
            handle = ServiceHandle(RoundRobinApp(apps) if len(apps) > 1 else apps[0],
                                   host, port, sock=sock)
        if watch_interval_s:
            from bodywork_tpu_torch.ops.slo import SloWatchdog, policy_from_env
            from bodywork_tpu_torch.serve.reload import NOTHING_SERVED, CheckpointWatcher

            tune_controller = None
            if online_tune:
                from bodywork_tpu_torch.tune.online import OnlineTuneController
                from bodywork_tpu_torch.tune.online import policy_from_env as tune_policy

                tune_controller = OnlineTuneController(
                    store, apps[0], policy=tune_policy(),
                    request_logs=tune_request_logs, results_logs=tune_results_logs)
                # reachable from the app for drills (a sabotage injects
                # through apply_tuned)
                apps[0].tune_controller = tune_controller
            # the SLO watchdog, then the tune controller, ride the watcher's
            # polls: canary routing, breach detection and the one-CAS abort
            # or promote; drift, refit and the one-CAS config revert
            watcher = CheckpointWatcher(
                apps, store, poll_interval_s=watch_interval_s, engine=engine,
                served_key=model_key if model is not None else NOTHING_SERVED,
                buckets=buckets, slo_watchdog=SloWatchdog(store, apps, policy=policy_from_env()),
                dtype=dtype, device=model.device if model is not None else resolve_device(device),
                tune_controller=tune_controller, mesh_data=mesh_data, mesh_model=mesh_model,
            )
        elif online_tune:
            log.warning("--online-tune requested without a watch interval; the "
                        "controller rides the reload-watcher loop — set "
                        "watch_interval_s to arm it")
    except BaseException:
        for app in apps:
            app.close()
        raise
    handle.watcher = watcher
    if watcher is not None:
        # first on stop: no swap lands on a stopped coalescer
        handle.add_cleanup(watcher.stop)
        watcher.start()
    for app in apps:
        handle.add_cleanup(app.close)
    if not block:
        return handle.start()
    try:
        handle.serve_forever()
    except ShutdownRequested:
        # stop admitting first (new scoring requests shed with
        # Retry-After), then stop: watcher joined, coalescers flushed,
        # listener closed
        log.warning("SIGTERM: draining scoring service "
                    "(admission closed, in-flight work finishing)")
        if admission is not None:
            admission.begin_drain()
        handle.stop()
    return None


def serve_latest_model(store, host: str = "0.0.0.0", port: int = 5000,
                       block: bool = True, engine: str = "auto", device=None,
                       buckets: tuple[int, ...] | None = None, dtype: str = "float32",
                       batch_window_ms: float | None = None,
                       batch_max_rows: int | None = None, server_engine: str = "thread",
                       max_pending: int | None = None,
                       retry_after_max_s: float | None = None,
                       watch_interval_s: float | None = None,
                       tuned_config: str | None = None, online_tune: bool = False,
                       tune_request_logs: tuple = (), tune_results_logs: tuple = (),
                       cost_budget_s: float | None = None, sock=None, shared_slot=None,
                       metrics_dir: str | None = None, mesh_data: int | None = None,
                       mesh_model: int = 1):
    """Load the checkpoint to serve (the ``production`` alias where the
    store has a registry, else the newest checkpoint the gate has not
    rejected: :func:`resolve_serving_key`) onto ``device`` (the card
    unless asked for the CPU; no CUDA and no ``device="cpu"`` raises) and
    serve it (:func:`serve_model`, with its front-end, coalescer and
    admission knobs) with its record's sanity band, in ``dtype`` if the
    shadow quality gate admits it. ``watch_interval_s`` hot-swaps the
    checkpoint serving should run from then on (``serve.reload``); with
    it, a store with no serviceable checkpoint yet (or an unreadable
    alias document) boots a service answering 503 + ``Retry-After``
    until one lands, where without it the error raises. ``store`` is an
    artefact store or a store directory. With ``block=False`` returns a
    started handle. ``tuned_config``, ``cost_budget_s``, ``online_tune``
    and the ``tune_*_logs`` are :func:`serve_model`'s (the tuned knobs
    resolve there, before any predictor is built), and so are a
    replica's ``sock``, ``shared_slot`` and ``metrics_dir`` and the mesh
    knobs ``mesh_data`` / ``mesh_model``."""
    from bodywork_tpu_torch.registry.records import RegistryCorrupt
    from bodywork_tpu_torch.store.base import ArtefactNotFound

    dev = resolve_device(device)
    store = open_store(store)
    try:
        served_key, served_source = resolve_serving_key(store)
        model, model_date = load_model(store, served_key, device=dev)
    except (ArtefactNotFound, RegistryCorrupt) as exc:
        if not watch_interval_s:
            raise
        log.warning(f"no serviceable checkpoint at boot ({exc!r}); serving 503s "
                    "until the checkpoint watcher resolves one")
        served_key = served_source = model = model_date = None
    return serve_model(model, model_date, host, port, block=block, engine=engine,
                       buckets=buckets, model_key=served_key, model_source=served_source,
                       model_bounds=registry_bounds(store, served_key), dtype=dtype,
                       store=store, batch_window_ms=batch_window_ms,
                       batch_max_rows=batch_max_rows, server_engine=server_engine,
                       max_pending=max_pending, retry_after_max_s=retry_after_max_s,
                       watch_interval_s=watch_interval_s, device=dev,
                       tuned_config=tuned_config, online_tune=online_tune,
                       tune_request_logs=tune_request_logs,
                       tune_results_logs=tune_results_logs, cost_budget_s=cost_budget_s,
                       sock=sock, shared_slot=shared_slot, metrics_dir=metrics_dir,
                       mesh_data=mesh_data, mesh_model=mesh_model)
