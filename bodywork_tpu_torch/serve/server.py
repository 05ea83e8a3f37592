"""Scoring-service lifecycle (the port of ``bodywork_tpu.serve.server``).

:func:`serve_latest_model` loads the checkpoint to serve (the registry's
``production`` alias, or the newest checkpoint on a store without one)
onto the card and hands it to :func:`serve_model`, which picks the engine,
warms every bucket and serves over ``http.server.ThreadingHTTPServer``
(the day loop's serve stage calls :func:`serve_model` itself); with
``block=False`` they return a started :class:`ServiceHandle`. With
``replicas > 1`` the requests alternate over N scoring apps that share
one predictor (:class:`RoundRobinApp`).

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
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from bodywork_tpu_torch.device import require_ieee_f32_matmul, resolve_device
from bodywork_tpu_torch.models.checkpoint import load_model, resolve_serving_key
from bodywork_tpu_torch.models.mlp import MLPRegressor
from bodywork_tpu_torch.serve.app import ScoringApp
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.server")

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
                   smem_budget: int | None = None, max_active=None) -> str:
    """Resolve ``engine="auto"``: on a CUDA device, the fused f32 kernel
    for an MLP whose narrowest hidden layer is at least
    :data:`KERNEL_AUTO_MIN_WIDTH` wide and that the kernel can launch;
    the plain ``torch`` engine otherwise. Explicit engine choices pass
    through untouched (and a kernel that cannot launch the model raises
    when the predictor is built).

    Whether the kernel can launch is a plan-time question
    (:func:`~bodywork_tpu_torch.ops.mlp_kernel.launch_refusal`): the
    layer cap, the card's SM count and opt-in shared memory a block
    (``n_sms`` / ``smem_budget``, read from the device when not given),
    and the card's cluster occupancy query (``max_active``, the built
    kernel's own when not given). A refusal is logged with its reason."""
    if engine != "auto":
        return engine
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


def build_predictor(model, engine: str = "auto",
                    buckets: tuple[int, ...] | None = None):
    """The predictor for an engine choice (``auto`` resolved against the
    model's device). The quantized engines refuse a model that is not an
    MLP with ``ValueError``."""
    from bodywork_tpu_torch.serve.predictor import (
        DEFAULT_BUCKETS,
        BF16MLPPredictor,
        Int8MLPPredictor,
        KernelMLPPredictor,
        PaddedPredictor,
    )

    engine = resolve_engine(engine, model, model.device)
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
                            dtype: str = "float32", policy=None):
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
    it). A kernel that fails to build or launch raises."""
    if dtype in (None, "float32"):
        return build_predictor(model, engine, buckets=buckets), "float32"
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
        return f32_predictor, "float32"
    try:
        report = shadow_compare(store, quant_predictor.predict, f32_predictor.predict,
                                days=policy.quantized_shadow_days)
    except ValueError as exc:
        if "no dataset history" not in str(exc):
            raise
        log.warning(f"dtype={dtype}: no dataset history to shadow the quantized variant "
                    "over; keeping f32 serving (quantization gate outcome=no_shadow_data)")
        return f32_predictor, "float32"
    ok, detail = evaluate_quantization(report, policy)
    if not ok:
        log.warning(f"dtype={dtype} REJECTED by the shadow quality gate ({detail}); keeping "
                    "f32 serving (quantization gate outcome=rejected_quality)")
        return f32_predictor, "float32"
    log.info(f"dtype={dtype} admitted by the shadow quality gate ({detail}) "
             f"(quantization gate outcome=served)")
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
               content_type: str | None = None):
        with self._lock:
            app = self.apps[next(self._counter) % len(self.apps)]
        return app.handle(method, path, body, content_type)


def _handler_for(app):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _respond(self, method: str) -> None:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            status, headers, payload = app.handle(
                method, self.path, body, self.headers.get("Content-Type"),
            )
            self.send_response(status)
            for name, value in headers.items():
                self.send_header(name, value)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            self._respond("GET")

        def do_POST(self):
            self._respond("POST")

        def log_message(self, format, *args):
            log.debug(format % args)

    return Handler


class ServiceHandle:
    """A scoring service on a ``ThreadingHTTPServer`` (one thread per
    connection). ``port=0`` lets the OS pick a free port."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 5000):
        self.app = app
        #: the scoring apps behind the front (one unless replicated)
        self.replica_apps = list(getattr(app, "apps", [app]))
        self._server = ThreadingHTTPServer((host, port), _handler_for(app))
        self._server.daemon_threads = True
        self.host = host
        self.port = self._server.server_port
        self._thread = threading.Thread(
            # poll_interval bounds how long shutdown() blocks
            target=lambda: self._server.serve_forever(poll_interval=0.005),
            name="scoring-service",
            daemon=True,
        )

    @property
    def base_url(self) -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "") else self.host
        return f"http://{host}:{self.port}"

    @property
    def url(self) -> str:
        return f"{self.base_url}/score/v1"

    def start(self) -> "ServiceHandle":
        self._thread.start()
        log.info(f"scoring service listening on {self.url}")
        return self

    def serve_forever(self) -> None:
        """Serve in the calling thread (pod-entrypoint mode)."""
        log.info(f"scoring service listening on {self.url}")
        try:
            self._server.serve_forever()
        finally:
            self._server.server_close()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread.ident is not None:
            self._thread.join(timeout=10)
        log.info("scoring service stopped")


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


def serve_model(model, model_date=None, host: str = "0.0.0.0", port: int = 5000,
                block: bool = True, engine: str = "auto",
                buckets: tuple[int, ...] | None = None, replicas: int = 1,
                model_key: str | None = None, model_source: str | None = None,
                model_bounds=None, dtype: str = "float32", store=None):
    """Serve a loaded model from its device: build the predictor for the
    engine and dtype (:func:`build_serving_predictor`; a quantized dtype
    shadows over ``store``'s datasets), warm every bucket (so a kernel that
    fails to build or launch fails the start, not a request), and serve
    through ``replicas`` scoring apps that share the predictor, each behind
    the prediction-sanity firewall with ``model_bounds`` as its band. With
    ``block=False`` returns a started :class:`ServiceHandle`."""
    if dtype not in (None, "float32") and store is None:
        raise ValueError(f"dtype={dtype} needs the store whose datasets its shadow "
                         "gate scores")
    predictor, served_dtype = build_serving_predictor(store, model, engine,
                                                      buckets=buckets, dtype=dtype)
    log.info(f"serving {model.info} on {model.device} through engine "
             f"{predictor.engine!r} in {served_dtype} ({max(replicas, 1)} replica(s))")
    apps = [
        ScoringApp(model, model_date, predictor=predictor, model_key=model_key,
                   model_source=model_source, model_bounds=model_bounds)
        for _ in range(max(replicas, 1))
    ]
    predictor.warmup()
    handle = ServiceHandle(RoundRobinApp(apps) if len(apps) > 1 else apps[0], host, port)
    if block:
        handle.serve_forever()
        return None
    return handle.start()


def serve_latest_model(store, host: str = "0.0.0.0", port: int = 5000,
                       block: bool = True, engine: str = "auto", device=None,
                       buckets: tuple[int, ...] | None = None, dtype: str = "float32"):
    """Load the checkpoint to serve (the ``production`` alias where the
    store has a registry, else the newest checkpoint the gate has not
    rejected: :func:`resolve_serving_key`) onto ``device`` (the card
    unless asked for the CPU; no CUDA and no ``device="cpu"`` raises) and
    serve it (:func:`serve_model`) with its record's sanity band, in
    ``dtype`` if the shadow quality gate admits it. ``store`` is an
    artefact store or a store directory. With ``block=False`` returns a
    started :class:`ServiceHandle`."""
    dev = resolve_device(device)
    store = open_store(store)
    served_key, served_source = resolve_serving_key(store)
    model, model_date = load_model(store, served_key, device=dev)
    return serve_model(model, model_date, host, port, block=block, engine=engine,
                       buckets=buckets, model_key=served_key, model_source=served_source,
                       model_bounds=registry_bounds(store, served_key), dtype=dtype,
                       store=store)
