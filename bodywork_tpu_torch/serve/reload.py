"""Model hot reload for the scoring service (the port of
``bodywork_tpu.serve.reload``).

A :class:`CheckpointWatcher` polls the store for the checkpoint serving
should run: the registry's ``production`` alias where one exists (so a
gate promotion or a ``registry rollback`` reaches a running service on
its next poll), else the newest date-keyed checkpoint under ``models/``.
It compares the target key and the backend's version token, so an
in-place overwrite is seen too, loads the new checkpoint onto the served
model's device and builds its predictor through
``serve.server.build_serving_predictor`` (a quantized serving dtype
re-runs its shadow gate), warms it on the watcher thread, then swaps it
into every app at once (``ScoringApp.swap_model``). On the card a
same-architecture checkpoint rebinds the captured CUDA graphs and
captures nothing; another architecture captures its graphs here, on a
side stream in ``thread_local`` mode, while request threads replay. A
canary is built in the weight-slot lane beside production's
(``serve.predictor``), so its requests never rebind production's weights.

Each poll also reconciles the apps' canary with the alias document's
slot (loading a new canary off the request path, clearing a retired one,
repairing a dangling slot), drives the SLO watchdog (``ops.slo``), then
the online tune controller where one rides the loop (``tune.online``).
Its ladder changes land through :meth:`CheckpointWatcher.apply_bucket_ladder`:
the served predictor on the new ladder, same model, weights and lane,
warmed here (a new rung is captured on this thread, never on a request)
before the swap.

The watcher's thread is not a daemon, unlike the JAX package's: a daemon
thread still inside a torch call at interpreter teardown aborts the
process. :meth:`CheckpointWatcher.stop` stops and joins it; a service's
cleanups (its SIGTERM drain included) call it. Mesh swaps are a later
slice (ROADMAP Queue 1 item 19) and raise.
"""
from __future__ import annotations

import threading

from bodywork_tpu_torch.models.checkpoint import (
    load_model,
    resolve_serving_key,
    resolve_serving_state,
)
from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore
from bodywork_tpu_torch.store.schema import MODELS_PREFIX
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.reload")

#: ``served_key`` for "the caller serves no model" (a degraded boot on an
#: empty store): the first checkpoint found is new. None instead would
#: snapshot the latest checkpoint as already served, and one published
#: between the caller's failed lookup and the watcher's start would
#: never load.
NOTHING_SERVED = object()


class CheckpointWatcher:
    """Polls ``store`` for the checkpoint to serve and hot-swaps it into
    ``app`` (one app, or a list of replica apps sharing one load). The
    load, the predictor build and its warm-up run on the watcher's
    thread; the request path sees only the finished swap."""

    def __init__(self, app, store: ArtefactStore, poll_interval_s: float = 30.0,
                 engine: str = "auto", served_key=None,
                 buckets: tuple[int, ...] | None = None, slo_watchdog=None,
                 dtype: str = "float32", device=None, mesh_data: int | None = None,
                 mesh_model: int = 1, tune_controller=None):
        if (mesh_data or 0) > 1 or mesh_model > 1:
            raise NotImplementedError(
                "serving over a device mesh is not ported yet (ROADMAP Queue 1 item 19, "
                "the mesh on torch.distributed)"
            )
        self.apps = list(app) if isinstance(app, (list, tuple)) else [app]
        self.store = store
        self.poll_interval_s = poll_interval_s
        self.engine = engine
        #: the serving dtype: a swapped-in checkpoint re-runs its shadow gate
        self.dtype = dtype
        #: where swapped-in checkpoints load: the served model's device,
        #: else the card unless asked for the CPU
        current = self.apps[0].predictor
        self.device = device if device is not None else (
            current.device if current is not None else None)
        #: the caller's explicit bucket list, kept across swaps
        self.buckets = tuple(buckets) if buckets else None
        # what the apps serve now: (key, version token). The caller passes
        # the key it loaded; snapshotting the latest here would skip a
        # checkpoint published while the caller warmed up.
        self._current: tuple | None = None
        if served_key is NOTHING_SERVED:
            served_key = None
        elif served_key is None:
            try:
                served_key, _source = resolve_serving_key(store)
            except ArtefactNotFound:
                served_key = None
            except Exception as exc:  # e.g. a corrupt alias document
                log.error(f"serving-key resolution failed at watcher init "
                          f"(polls will retry): {exc!r}")
                served_key = None
        if served_key is not None:
            self._current = (served_key, store.version_token(served_key))
        #: whether this watcher flagged the apps degraded for a failing
        #: resolution (a healed one that needs no swap clears exactly that)
        self._resolve_degraded = False
        #: the canary the apps serve: (key, token, fraction, seed)
        self._current_canary: tuple | None = None
        #: the SLO watchdog (``ops.slo``), polled once a cycle
        self.slo_watchdog = slo_watchdog
        #: the online tune controller (``tune.online``), polled right after
        #: the watchdog; its ladder changes go through this watcher
        self.tune_controller = tune_controller
        if tune_controller is not None and tune_controller.apply_buckets is None:
            tune_controller.apply_buckets = self.apply_bucket_ladder
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="checkpoint-watcher")

    def check_once(self) -> bool:
        """One poll: swap when the store resolves another checkpoint to
        serve. Returns whether a swap happened. A failed load or warm-up,
        or a corrupt alias document, is logged and the apps keep serving
        their model, flagged degraded on /healthz and the gauge, until a
        later poll succeeds."""
        try:
            key, source, canary_state, canary_dangling = resolve_serving_state(self.store)
        except ArtefactNotFound:
            self._poll_watchdog()
            self._poll_tuner()
            return False
        except Exception as exc:
            # e.g. RegistryCorrupt: the latest checkpoint might be ungated,
            # so keep serving, and say that promotions are not landing
            log.error(f"serving-key resolution failed (will retry): {exc!r}")
            if not self._resolve_degraded:
                self._resolve_degraded = True
                for app in self.apps:
                    app.set_degraded("serving-key resolution failing; promotions and "
                                     "rollbacks are not taking effect")
            return False
        if self._resolve_degraded:
            self._resolve_degraded = False
            for app in self.apps:
                app.clear_degraded()
        swapped = False
        candidate = (key, self.store.version_token(key))
        if candidate != self._current:
            try:
                model, model_date = load_model(self.store, key, device=self.device)
                predictor = self._build_swap_predictor(model)
            except Exception as exc:
                log.error(f"hot reload of {key} failed (will retry): {exc!r}")
                for app in self.apps:
                    app.set_degraded(f"hot reload of {key} failed; serving last-good model")
                self._sync_canary(canary_state, canary_dangling)
                self._poll_watchdog()
                self._poll_tuner()
                return False
            # a coalesced batch holds one bundle's rows only, so a swap
            # landing mid-queue splits old and new rows into separate calls
            bounds = self._record_bounds(key)
            for app in self.apps:
                app.swap_model(model, model_date, predictor, model_key=key,
                               model_source=source, model_bounds=bounds)
            self._current = candidate
            swapped = True
        self._sync_canary(canary_state, canary_dangling)
        self._poll_watchdog()
        self._poll_tuner()
        return swapped

    def _build_swap_predictor(self, model, canary: bool = False):
        """A warmed predictor for a model being swapped in (production or
        ``canary``): the boot's engine selection and, for a quantized
        dtype, its shadow gate. Buckets: the caller's list, else the
        served predictor's when the engine resolves the same, else the
        new engine's own. Weight-slot lane: production's for a swap, the
        other one for a canary."""
        from bodywork_tpu_torch.serve.predictor import use_serving_lane
        from bodywork_tpu_torch.serve.server import build_serving_predictor, resolve_engine

        current = self.apps[0].predictor  # None on a degraded boot
        old_resolved = (resolve_engine(self.engine, current.model, current.device)
                        if current is not None and hasattr(current, "model") else None)
        new_resolved = resolve_engine(self.engine, model, model.device)
        if self.buckets is not None:
            swap_buckets = self.buckets
        elif current is not None and new_resolved == old_resolved:
            swap_buckets = current.buckets
        else:
            swap_buckets = None
        predictor, _served_dtype = build_serving_predictor(
            self.store, model, new_resolved, buckets=swap_buckets, dtype=self.dtype)
        use_serving_lane(predictor, current, canary)
        # every bucket captured (or rebound) and run before the swap
        predictor.warmup()
        return predictor

    def _record_bounds(self, key: str):
        """The checkpoint's registry sanity band, under the boot's rule."""
        from bodywork_tpu_torch.serve.server import registry_bounds

        return registry_bounds(self.store, key)

    def _sync_canary(self, state: dict | None, dangling_reason: str | None) -> None:
        """Reconcile the apps' canary with the alias document's slot: load
        and warm a new canary off the request path, clear a retired one,
        and repair a dangling slot (one CAS and a repair event)."""
        if dangling_reason is not None:
            log.warning(f"dangling canary slot ignored ({dangling_reason}); "
                        "serving production only")
            try:
                from bodywork_tpu_torch.registry import ModelRegistry

                ModelRegistry(self.store).canary_repair(reason=dangling_reason)
            except Exception as exc:
                log.error(f"canary slot repair failed (will retry): {exc!r}")
            state = None
        if state is None:
            if self._current_canary is not None or self.apps[0].canary_key is not None:
                for app in self.apps:
                    app.clear_canary()
                self._current_canary = None
            return
        desired = (state["key"], self.store.version_token(state["key"]),
                   state["fraction"], state["seed"])
        if desired == self._current_canary:
            return
        try:
            model, model_date = load_model(self.store, state["key"], device=self.device)
            predictor = self._build_swap_predictor(model, canary=True)
        except Exception as exc:
            # neither the service nor production goes down with a
            # half-written canary: retry next poll
            log.error(f"canary load of {state['key']} failed (will retry): {exc!r}")
            return
        for app in self.apps:
            app.set_canary(model, model_date, predictor, model_key=state["key"],
                           fraction=state["fraction"], seed=state["seed"],
                           bounds=state.get("bounds"))
        self._current_canary = desired

    def apply_bucket_ladder(self, buckets: tuple) -> None:
        """Swap the served predictor onto the ladder ``buckets`` without
        changing the model (the online tune controller's ladder apply).
        The new predictor is the served one on the new ladder
        (``PaddedPredictor.with_buckets``): the same model, key, weights
        and weight-slot lane, so requests still in flight on the old one
        never rebind the slot against it. It is warmed here, on the
        watcher's thread, before the swap: a rung already captured for
        the architecture captures nothing, a new one is captured (or
        refused) here and never on a scoring request. The ladder is
        pinned as this watcher's bucket policy for later model swaps."""
        app = self.apps[0]
        current = app.predictor
        key = app.model_key
        if current is None or key is None:
            raise RuntimeError("no model is served; cannot apply a ladder")
        self.buckets = ladder = tuple(buckets)
        predictor = current.with_buckets(ladder)
        predictor.warmup()
        model = current.model
        bounds = self._record_bounds(key)
        model_date, source = app.model_date, app.model_source
        # identity-preserving: same model, key, date and source, so the
        # bodies stay byte-identical across the ladder change
        for each in self.apps:
            each.swap_model(model, model_date, predictor, model_key=key,
                            model_source=source, model_bounds=bounds)
        self._current = (key, self.store.version_token(key))
        log.info(f"bucket ladder applied live: {ladder}")

    def _poll_tuner(self) -> None:
        """Drive the online tune controller once a poll, after the
        watchdog; a controller error must never stop model reloads."""
        if self.tune_controller is None:
            return
        try:
            self.tune_controller.poll()
        except Exception as exc:
            log.error(f"online tune poll failed: {exc!r}")

    def _poll_watchdog(self) -> None:
        """Drive the SLO watchdog once. A promote re-anchors the current
        production, so the next poll does not reload what already
        serves."""
        if self.slo_watchdog is None:
            return
        try:
            action = self.slo_watchdog.poll()
        except Exception as exc:  # the watchdog must never stop reloads
            log.error(f"SLO watchdog poll failed: {exc!r}")
            return
        if action == "promote":
            key = self.apps[0].model_key
            if key is not None:
                self._current = (key, self.store.version_token(key))
            self._current_canary = None
        elif action == "abort":
            self._current_canary = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.check_once()
            except Exception as exc:  # a poll error must not end the loop
                log.error(f"checkpoint watch poll failed: {exc!r}")

    def start(self) -> "CheckpointWatcher":
        self._thread.start()
        log.info(f"watching the serving target every {self.poll_interval_s:g}s "
                 f"(registry production alias when one exists, else newest under "
                 f"{MODELS_PREFIX})")
        return self

    def stop(self) -> None:
        """Stop polling and join the thread (a poll in flight finishes)."""
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join()
