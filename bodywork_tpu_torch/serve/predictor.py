"""Shape-bucketed prediction wrappers for serving, over a per-bucket
CUDA-graph cache (the port of ``bodywork_tpu.serve.predictor``).

Each request's row count is padded up to a fixed bucket, and oversized
requests are chunked through the largest bucket, so the device runs a
small, pre-warmable set of shapes whatever the traffic. The buckets are
the JAX package's, so the same requests pad to the same shapes in both:

- :class:`PaddedPredictor` (engine ``torch``): buckets
  ``(1, 8, 64, 512, 4096)`` over the model's plain float32 ``apply``
  (``mlp_apply`` or ``linear_apply``);
- :class:`BF16MLPPredictor` (engine ``torch-bf16``) and
  :class:`Int8MLPPredictor` (``torch-int8``): an MLP's plain apply with
  bf16 activations, weights and biases, or from int8 weights quantized
  once and kept on the device (the JAX ``xla-bf16`` / ``xla-int8``),
  on the same buckets;
- :class:`KernelMLPPredictor` (engines ``kernel``, ``kernel-bf16``,
  ``kernel-int8``): the fused CUDA kernel (``ops.mlp_kernel``) with the
  Pallas predictor's bucket policy ``(tile, 2·tile, 16·tile)``.

Each predictor names its serving ``dtype`` (:data:`SERVE_DTYPES`), which
``/healthz`` reports as ``serving_dtype``.

**The graph cache** (:data:`GRAPH_CACHE`) takes the place of the JAX
package's process-wide AOT executable cache. Every bucket of every
predictor dispatches through it. An entry is keyed by (predictor class,
model class, serving dtype, :func:`params_shape_digest`, bucket,
n_features, device), blind to the parameter values, and is never
evicted. On the card an entry holds one captured ``torch.cuda.CUDAGraph``
with its static input and output, a pinned staging buffer on each side,
and the static weight buffers it reads, which all the buckets of one
architecture share (a *slot*). A dispatch copies the host batch into the
static input, replays the graph and reads the output back. On the CPU
there is no graph: the entry runs the plain version eagerly over the same
static buffers, so the keys, the counts, the re-binding and the locking
are the same there.

A graph bakes in the pointers it was captured with, where the JAX
executable took the params as arguments. So a slot records whose weights
its buffers hold, and a dispatch for another predictor of the same
architecture first copies that predictor's weights in (a *rebind*: a
same-architecture hot swap captures nothing). An architecture has two
slots, *lanes* 0 and 1, each with its own graphs: production serves from
one and a live canary from the other (:func:`use_serving_lane`), so the
two streams never rebind each other's
weights on the request path; the first canary of an architecture
captures its lane's graphs at its warm-up, and later ones rebind them.
One lock per slot covers
the staging, the copy in, the rebind, the replay and the copy out, so
every front end's threads may dispatch through it. A capture runs on a
side stream in ``thread_local`` error mode, so work other threads launch
meanwhile (the day loop's lookahead train) neither breaks it nor is
broken by it. A capture that fails on the card raises: nothing falls
back to eager dispatch.

``BODYWORK_TPU_AOT_CACHE=0`` keeps its JAX meaning: no reuse across
predictor instances. Each predictor still captures its own graphs.
"""
from __future__ import annotations

import atexit
import copy
import itertools
import os
import threading
import time

import numpy as np
import torch

from bodywork_tpu_torch.device import require_ieee_f32_matmul
from bodywork_tpu_torch.models.mlp import MLPRegressor, mlp_apply
from bodywork_tpu_torch.obs.tracing import annotate_active
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.predictor")

DEFAULT_BUCKETS = (1, 8, 64, 512, 4096)

#: the serving precisions (``serve --dtype``): a quantized one serves only
#: after the shadow quality gate admits it (``serve.server``)
SERVE_DTYPES = ("float32", "bfloat16", "int8")

#: set to "0" to disable cross-instance graph reuse (each predictor then
#: captures its own buckets); per-instance caching and the hit/miss
#: accounting stay on either way
AOT_CACHE_ENV = "BODYWORK_TPU_AOT_CACHE"

#: one capture at a time in the process
_CAPTURE_LOCK = threading.Lock()


def _leaves(tree):
    """The tensors of a nested dict/list/tuple in a fixed order (dict keys
    sorted, as ``jax.tree_util`` orders them); None leaves are skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def params_shape_digest(params) -> tuple:
    """A hashable fingerprint of a params tree's architecture: every
    tensor's shape, dtype and device, in tree order, blind to the values.
    Two same-architecture checkpoints digest identically, which is what
    lets a hot swap re-bind the new weights to the captured graphs."""
    return tuple((tuple(t.shape), str(t.dtype), str(t.device)) for t in _leaves(params))


class _WeightSlot:
    """The static weight buffers the graphs of one architecture read, the
    token of the predictor whose weights they hold, and the lock every
    dispatch through those graphs takes."""

    def __init__(self, weights, owner: int):
        self.weights = _tree_map(lambda t: t.detach().clone(), weights)
        self.owner = owner
        self.lock = threading.Lock()
        #: a hint that a dispatch found the lock taken since the last yield
        self.contended = False

    def acquire(self) -> None:
        if not self.lock.acquire(blocking=False):
            self.contended = True
            self.lock.acquire()

    def release(self) -> None:
        """Release the lock; if a dispatch was waiting, hand it the
        interpreter: this thread would otherwise take the lock again on
        its next request before the woken one runs, and a waiting thread
        could miss its turn for milliseconds (the p99 of concurrent single
        rows). An uncontended dispatch pays nothing."""
        self.lock.release()
        if self.contended:
            self.contended = False
            time.sleep(0)


class _CapturedProgram:
    """One static-shape program: on the card a captured CUDA graph with its
    static input and output and pinned staging buffers, on the CPU the
    plain version run eagerly over the static input. The solo serving
    buckets (:class:`_BucketGraph`) and the tenant stack
    (``tenancy.stacked``) both dispatch through it."""

    def __init__(self, runner, shape: tuple, device: torch.device):
        self.device = device
        self.graph = None
        self.runner = runner
        with torch.no_grad():
            self.x = torch.zeros(shape, dtype=torch.float32, device=device)
            if device.type != "cuda":
                runner(self.x)  # a shape or weight fault raises here, at build
                return
            # warm on the side stream the capture uses (workspaces, kernel
            # attributes), then capture there; thread_local: other threads'
            # work meanwhile is theirs, and not recorded or refused
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                runner(self.x)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.out = runner(self.x)
                finally:
                    graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(side)
        self.graph = graph
        self.staging = torch.empty(self.x.shape, dtype=torch.float32, pin_memory=True)
        self.out_host = torch.empty(self.out.shape, dtype=self.out.dtype, pin_memory=True)
        self.done = torch.cuda.Event()

    def run(self, X: np.ndarray, on_replay=None) -> np.ndarray:
        """Copy ``X`` in, run or replay, and copy the output out;
        ``on_replay()`` is called after each replay is launched. The caller
        holds whatever lock guards the buffers and the weights."""
        with torch.no_grad():
            if self.graph is None:
                self.x.numpy()[...] = X
                return self.runner(self.x).numpy().copy()
            stream = torch.cuda.current_stream(self.device)
            self.staging.numpy()[...] = X
            self.x.copy_(self.staging, non_blocking=True)
            self.graph.replay()
            if on_replay is not None:
                on_replay()
            self.out_host.copy_(self.out, non_blocking=True)
            self.done.record(stream)
            self.done.synchronize()
            return self.out_host.numpy().copy()


class _BucketGraph(_CapturedProgram):
    """One bucket's program over a shared weight slot. ``engine`` names
    the kernel a replay launches (None for the plain engines)."""

    def __init__(self, slot: _WeightSlot, runner, bucket: int, n_features: int,
                 device: torch.device, engine: str | None):
        self.slot = slot
        self.engine = engine
        super().__init__(runner, (bucket, n_features), device)

    def run(self, Xp: np.ndarray, owner: int, weights, cache: "GraphCache") -> np.ndarray:
        """Score one padded batch with ``owner``'s ``weights``: rebind the
        slot if another predictor's weights are in it, then copy in, run
        or replay, and copy out, all under the slot's lock."""
        slot = self.slot
        slot.acquire()
        try:
            if slot.owner != owner:
                # every leaf in one call (a fused copy on the card), not
                # one copy launch per leaf on the request path
                with torch.no_grad():
                    torch._foreach_copy_(list(_leaves(slot.weights)), list(_leaves(weights)))
                slot.owner = owner
                cache.count_rebind()
            return super().run(Xp, lambda: cache.count_replay(self.engine))
        finally:
            slot.release()


class GraphCache:
    """Process-wide cache of the serving buckets' programs (see the module
    docstring). ``hits`` and ``misses`` count first sights of a bucket by
    a predictor instance, as the JAX executable cache counts them;
    ``rebinds`` the weight copies into a slot; ``captures`` and
    ``replays`` the CUDA graphs captured and replayed. The obs counters
    keep the JAX names: ``bodywork_tpu_serve_executable_cache_{hits,
    misses}_total`` and ``bodywork_tpu_serve_compile_seconds`` (here the
    seconds of a build: the capture on the card)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._graphs: dict[tuple, _BucketGraph] = {}
        self._slots: dict[tuple, _WeightSlot] = {}
        self.hits = self.misses = self.rebinds = self.captures = self.replays = 0
        self._metrics = None

    def _obs(self):
        if self._metrics is None:
            from bodywork_tpu_torch.obs import get_registry

            reg = get_registry()
            self._metrics = (
                reg.counter(
                    "bodywork_tpu_serve_executable_cache_hits_total",
                    "Serving-bucket executable requests answered from the "
                    "process-wide AOT cache (no compile)",
                ),
                reg.counter(
                    "bodywork_tpu_serve_executable_cache_misses_total",
                    "Serving-bucket executables compiled (cache miss); a "
                    "nonzero rate on the request path is a warmup bug",
                ),
                reg.histogram(
                    "bodywork_tpu_serve_compile_seconds",
                    "Wall time of one serving-bucket AOT lower+compile "
                    "(executable-cache miss)",
                ),
            )
        return self._metrics

    @staticmethod
    def enabled() -> bool:
        return os.environ.get(AOT_CACHE_ENV, "1") != "0"

    def slot(self, key: tuple, weights, owner: int) -> _WeightSlot:
        """The shared weight slot of an architecture (a new one holding
        ``owner``'s ``weights`` on first sight); with the cache disabled,
        always a new slot for the caller alone."""
        if not self.enabled():
            return _WeightSlot(weights, owner)
        with self._lock:
            slot = self._slots.get(key)
            if slot is None:
                slot = self._slots[key] = _WeightSlot(weights, owner)
            return slot

    def get(self, key: tuple, build) -> _BucketGraph:
        """The program for ``key``, built by ``build()`` (a capture on the
        card) on a miss. With the cache disabled every call builds, and
        still counts."""
        hits, misses, compile_s = self._obs()
        if self.enabled():
            with self._lock:
                entry = self._graphs.get(key)
                if entry is not None:
                    self.hits += 1
            if entry is not None:
                hits.inc()
                return entry
        t0 = time.perf_counter()
        entry = build()
        seconds = time.perf_counter() - t0
        with self._lock:
            self.misses += 1
            self.captures += entry.graph is not None
            if self.enabled():
                self._graphs[key] = entry
        misses.inc()
        compile_s.observe(seconds)
        return entry

    def count_rebind(self) -> None:
        with self._lock:
            self.rebinds += 1

    def count_replay(self, engine: str | None) -> None:
        """One replay; a replay of a kernel's graph is one launch of it."""
        with self._lock:
            self.replays += 1
        if engine is not None:
            from bodywork_tpu_torch.ops.mlp_kernel import count_launch

            count_launch(engine)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._graphs),
                "hits": self.hits,
                "misses": self.misses,
                "rebinds": self.rebinds,
                "captures": self.captures,
                "replays": self.replays,
            }

    def reset(self) -> None:
        """Drop every entry and zero the counts (tests, and a measurement
        that must see a cold cache). Predictors keep the entries they
        already hold."""
        with self._lock:
            self._graphs.clear()
            self._slots.clear()
            self.hits = self.misses = self.rebinds = self.captures = self.replays = 0


#: THE process-wide graph cache
GRAPH_CACHE = GraphCache()
# drop the graphs while torch is still whole, not at module teardown
atexit.register(GRAPH_CACHE.reset)


class PaddedPredictor:
    """Bucket-padding predictor over the model's plain f32 apply (full
    IEEE float32 products: :func:`require_ieee_f32_matmul`), dispatched
    through :data:`GRAPH_CACHE`. Subclasses change the engine by
    overriding :meth:`_graph_weights` (the tensors the program reads) and
    :meth:`_graph_runner` (the program over a copy of them)."""

    #: the serving dtype tag (/healthz ``serving_dtype``)
    dtype = "float32"
    engine = "torch"

    #: monotonic instance tokens (``id(self)`` could be recycled)
    _tokens = itertools.count(1)

    def __init__(self, model, buckets: tuple[int, ...] = DEFAULT_BUCKETS):
        self.model = model
        self.buckets = tuple(sorted(buckets))
        self.device = model.device
        self._token = next(self._tokens)
        #: which of the architecture's two weight slots this predictor
        #: dispatches through (0 unless it serves beside another)
        self.slot_lane = 0
        #: per-instance handles: (bucket, n_features) -> program
        self._graphs: dict[tuple, _BucketGraph] = {}
        self._slot: _WeightSlot | None = None

    def use_lane(self, lane: int) -> None:
        """Dispatch through the architecture's weight slot ``lane`` (0 or
        1). Call it before :meth:`warmup`: the handles of the other lane
        are dropped, so the next dispatch of each bucket builds or finds
        its program in ``lane``."""
        if lane not in (0, 1):
            raise ValueError(f"slot lane must be 0 or 1, got {lane!r}")
        if lane != self.slot_lane:
            self.slot_lane = lane
            self._graphs.clear()
            self._slot = None

    def with_buckets(self, buckets: tuple[int, ...]) -> "PaddedPredictor":
        """This predictor on another bucket ladder: the same model, weights
        (and their owner token), weight-slot lane and handles, so a rung
        already captured for the architecture replays with no rebind and
        no capture, and only a new rung builds at :meth:`warmup`. Requests
        still on this predictor and on the new one share the slot's
        weights and never rebind each other (the online tuner's ladder
        swap, ``serve.reload.CheckpointWatcher.apply_bucket_ladder``)."""
        twin = copy.copy(self)
        twin.buckets = tuple(sorted(buckets))
        twin._graphs = dict(self._graphs)
        return twin

    # -- the program the graph cache holds ---------------------------------
    def _graph_weights(self):
        """The tensors this predictor's program reads."""
        return self.model.params

    def _graph_runner(self, weights):
        """``X -> y`` over ``weights`` (the slot's copy); it must hold no
        reference to this predictor, whose entry other instances share."""
        apply = type(self.model).apply
        return lambda X: apply(weights, X)

    def _graph_key_extra(self) -> tuple:
        return ()

    def _launch_engine(self) -> str | None:
        """The kernel a replay launches (None: plain torch ops)."""
        return None

    def _graph_for(self, bucket: int, n_features: int) -> _BucketGraph:
        """The bucket's program. The ``annotate_active`` calls are the
        tracing seam (``obs.tracing``), a contextvar read unless a sampled
        request's dispatch span is active, which records ``aot_cache``
        under the JAX package's values: ``warm`` (this instance already
        holds the bucket's graph), ``hit`` (the process-wide cache served
        it without a build) or ``miss`` (a build, on the card a capture,
        landed on the request path). A rebind is not a build."""
        entry = self._graphs.get((bucket, n_features))
        if entry is not None:
            annotate_active(aot_cache="warm", bucket=bucket)
            return entry
        weights = self._graph_weights()
        arch = (type(self).__name__, type(self.model).__qualname__, self.dtype,
                params_shape_digest(weights), str(self.device), self._graph_key_extra(),
                self.slot_lane)
        if self._slot is None:
            self._slot = GRAPH_CACHE.slot(arch, weights, self._token)
        slot = self._slot
        key = arch[:4] + ((bucket, n_features),) + arch[4:]

        def build() -> _BucketGraph:
            with _CAPTURE_LOCK:
                return _BucketGraph(slot, self._graph_runner(slot.weights), bucket,
                                    n_features, self.device, self._launch_engine())

        misses_before = GRAPH_CACHE.misses
        with slot.lock:
            entry = GRAPH_CACHE.get(key, build)
        self._graphs[(bucket, n_features)] = entry
        annotate_active(aot_cache="miss" if GRAPH_CACHE.misses > misses_before else "hit",
                        bucket=bucket)
        return entry

    def _predict_padded(self, Xp: np.ndarray) -> np.ndarray:
        """Score an exactly-bucket-sized batch through its program."""
        entry = self._graph_for(Xp.shape[0], Xp.shape[1])
        return entry.run(Xp, self._token, self._graph_weights(), GRAPH_CACHE)

    def warmup(self) -> None:
        """Build every bucket's program (a capture on the card, or a cache
        hit) and run each once before taking traffic, then fence, so a
        capture or launch that fails surfaces at boot rather than on the
        first request."""
        n_features = self.model.n_features or 1
        for b in self.buckets:
            self._predict_padded(np.zeros((b, n_features), dtype=np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log.info(f"warmed up predict buckets {self.buckets} (n_features={n_features})")

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float32)
        if X.ndim == 1:
            X = X[:, None]
        n = X.shape[0]
        max_bucket = self.buckets[-1]
        if n > max_bucket:
            # chunk through the largest bucket
            parts = [
                self.predict(X[i : i + max_bucket]) for i in range(0, n, max_bucket)
            ]
            return np.concatenate(parts)
        b = self._bucket_for(n)
        if b != n:
            Xp = np.zeros((b, X.shape[1]), dtype=np.float32)
            Xp[:n] = X
        else:
            Xp = X
        return self._predict_padded(Xp)[:n]


def use_serving_lane(predictor, production, canary: bool) -> None:
    """Before ``predictor``'s warm-up: put it in ``production``'s (the
    served predictor's, or None) weight-slot lane, or for a ``canary`` in
    the lane beside it. Predictors outside the graph cache are left as
    they are."""
    if hasattr(predictor, "use_lane"):
        lane = getattr(production, "slot_lane", 0)
        predictor.use_lane(1 - lane if canary else lane)


def _require_mlp(model, engine: str) -> None:
    if not isinstance(model, MLPRegressor):
        raise ValueError(f"engine {engine!r} serves MLP models; got {model.info}")


class BF16MLPPredictor(PaddedPredictor):
    """Serves an MLP with the dense stack in bfloat16, activations and
    biases included (``mlp_apply(..., compute_dtype="bfloat16")``; the JAX
    ``xla-bf16`` engine), unlike ``kernel-bf16``, which keeps f32
    activations. Predictions carry bf16's ~3 significant digits."""

    dtype = "bfloat16"
    engine = "torch-bf16"

    def __init__(self, model, buckets: tuple[int, ...] | None = None):
        _require_mlp(model, self.engine)
        super().__init__(model, buckets or DEFAULT_BUCKETS)

    def _graph_runner(self, weights):
        return lambda X: mlp_apply(weights, X, compute_dtype="bfloat16")


class Int8MLPPredictor(PaddedPredictor):
    """Serves an MLP from int8 weights (the JAX ``xla-int8`` engine): each
    dense weight is quantized once, here, to symmetric per-column int8
    (``models.fused.quantize_mlp_params_int8``) and kept on the device;
    every forward dequantizes it before an IEEE f32 product."""

    dtype = "int8"
    engine = "torch-int8"

    def __init__(self, model, buckets: tuple[int, ...] | None = None):
        from bodywork_tpu_torch.models import fused

        _require_mlp(model, self.engine)
        require_ieee_f32_matmul(model.device)
        super().__init__(model, buckets or DEFAULT_BUCKETS)
        self._qparams = fused.quantize_mlp_params_int8(model.params)

    def _graph_weights(self):
        return self._qparams

    def _graph_runner(self, weights):
        from bodywork_tpu_torch.models.fused import int8_mlp_apply

        return lambda X: int8_mlp_apply(weights, X)


class KernelMLPPredictor(PaddedPredictor):
    """Serves an MLP through the fused CUDA kernel
    (:mod:`bodywork_tpu_torch.ops.mlp_kernel`): scaler folded into the
    weights once, the whole forward one launch per padded batch, replayed
    from the bucket's graph. The program reads the kernel's padded
    weights; on a CPU-resident model the kernel's plain version runs over
    its unpadded layers instead (the CPU tests)."""

    def __init__(self, model, buckets: tuple[int, ...] | None = None,
                 compute_dtype: str | None = None):
        from bodywork_tpu_torch.ops.mlp_kernel import ROW_TILE, make_kernel_mlp_apply

        if not isinstance(model, MLPRegressor):
            raise ValueError(f"the fused kernel serves MLP models; got {model.info}")
        if buckets is None:
            # the Pallas predictor's policy: sub-tile buckets would only
            # duplicate programs there, and keeping it makes the same
            # requests pad to the same shapes in both packages
            buckets = (ROW_TILE, 2 * ROW_TILE, 16 * ROW_TILE)
        super().__init__(model, buckets)
        #: the kernel's ``apply`` (its ``layers`` are what the kernel reads)
        self.kernel = make_kernel_mlp_apply(
            model.params, self.device, compute_dtype=compute_dtype,
        )
        self.engine = self.kernel.engine
        self._compute_dtype = compute_dtype
        if compute_dtype in ("bfloat16", "int8"):
            self.dtype = compute_dtype

    def _graph_weights(self):
        launch = self.kernel.launch
        return self.kernel.layers if launch is None else launch.padded

    def _graph_runner(self, weights):
        launch = self.kernel.launch
        if launch is None:
            from bodywork_tpu_torch.ops.mlp_kernel import mlp_stack_plain

            dtype = self._compute_dtype
            return lambda X: mlp_stack_plain(weights, X, dtype)
        return launch.rebound(weights)

    def _graph_key_extra(self) -> tuple:
        # the launch plans follow the clusters the card schedules
        launch = self.kernel.launch
        return () if launch is None else tuple(sorted(launch.clusters.items()))

    def _launch_engine(self) -> str | None:
        return None if self.kernel.launch is None else self.engine

    def _predict_padded(self, Xp: np.ndarray) -> np.ndarray:
        d_in = self.kernel.layers[0]["w"].shape[0]
        if Xp.shape[1] != d_in:
            # zero-filling a short row would silently score garbage
            raise ValueError(f"expected {d_in} feature(s), got {Xp.shape[1]}")
        return super()._predict_padded(Xp)
