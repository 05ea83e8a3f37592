"""Stacked multi-tenant serving: many same-architecture MLPs, one dispatch
(the port of ``bodywork_tpu.tenancy.stacked``).

A :class:`StackedMLPPredictor` holds up to ``capacity`` tenants' MLP
parameters in one device tensor per parameter leaf, ``[capacity, ...]``,
and scores a multi-tenant batch ``[capacity, rows, features]`` in one
dispatch. The capacity is fixed for the predictor's life and a free slot
is zero-filled, so admission, eviction and re-admission only copy into
those tensors in place: on the card every bucket's program is one CUDA
graph captured once, at ``capacity`` slots, and a graph never sees a new
address, so residency churn captures nothing (the JAX stack's "never
compiles").

Two stacking programs, as in the JAX package:

- ``scan`` (default): a loop over the slots of the solo ``torch``
  engine's exact program (``models.mlp.mlp_apply``, what
  :class:`~bodywork_tpu_torch.serve.predictor.PaddedPredictor` runs) on
  each slot's views of the stacked tensors, captured on the card as one
  graph per bucket: one replay a dispatch. Each tenant's outputs are
  byte-identical to its own solo predictor's.
- ``vmap``: ``torch.bmm`` over the tenant axis, the batched form. Its
  products may reduce in another order than the solo program's, so it is
  close to solo, not bit-equal (:data:`VMAP_RTOL` of the outputs' scale).

The JAX package computes both in XLA (``lax.scan`` / ``vmap`` of
``mlp_apply``), not in a Pallas kernel, so their products stay plain
PyTorch here. Residency is LRU beyond the stack budget; ``canary_slots``
of the capacity are reserved for canary admissions, and ``row_budget``
bounds one tenant's rows per dispatch, enforced before any device work.
On the CPU a program runs eagerly over the same static buffers; on the
card it is a captured graph, and nothing falls back to the CPU.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from bodywork_tpu_torch.device import require_ieee_f32_matmul, resolve_device
from bodywork_tpu_torch.models.mlp import MLPRegressor, mlp_apply
from bodywork_tpu_torch.serve.predictor import (
    _CAPTURE_LOCK,
    _CapturedProgram,
    _leaves,
    _tree_map,
)
from bodywork_tpu_torch.store.schema import validate_tenant_id
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("tenancy.stacked")

#: the stacking programs (see the module docstring)
STACK_MODES = ("scan", "vmap")

#: default row buckets for the per-tenant axis: smaller than the solo
#: ladder's, because a stacked batch multiplies rows by capacity
DEFAULT_STACK_BUCKETS = (8, 64, 512)

#: ``vmap`` mode's distance from the solo program relative to the
#: outputs' scale (largest absolute difference over largest absolute solo
#: output), the bar its tests and ``chip_smoke.py`` hold (the JAX package
#: measured ~4e-6 relative on the CPU; the port's readings are in PERF.md)
VMAP_RTOL = 1e-4


class TenantNotResident(KeyError):
    """The tenant has no stack slot (admit before dispatch)."""


class TenantOverBudget(RuntimeError):
    """A tenant's rows exceed its per-tenant admission sub-budget."""


class StackNotCompatible(ValueError):
    """An admitted model's architecture differs from the stack's."""


def _tenancy_metrics():
    from bodywork_tpu_torch.obs import get_registry

    reg = get_registry()
    return (
        reg.counter(
            "bodywork_tpu_tenant_rows_total",
            "Rows scored through the stacked multi-tenant dispatch, "
            "by tenant",
        ),
        reg.counter(
            "bodywork_tpu_tenant_stack_dispatches_total",
            "Stacked multi-tenant device dispatches (each scores every "
            "occupied slot's rows in one executable call)",
        ),
        reg.counter(
            "bodywork_tpu_tenant_evictions_total",
            "Tenants evicted from the params stack under residency "
            "pressure, by tenant",
        ),
        reg.counter(
            "bodywork_tpu_tenant_admission_rejected_total",
            "Multi-tenant rows rejected by a per-tenant admission "
            "sub-budget, by tenant",
        ),
        reg.gauge(
            "bodywork_tpu_tenant_resident_count",
            "Tenants currently resident in the params stack",
        ),
    )


def _arch_digest(params) -> tuple:
    """Every leaf's shape and dtype in tree order, blind to the values and
    the device: two same-architecture models stack together."""
    return tuple((tuple(t.shape), str(t.dtype)) for t in _leaves(params))


def _vmap_apply(stacked, xb: torch.Tensor) -> torch.Tensor:
    """``mlp_apply`` batched over the tenant axis with ``torch.bmm``."""
    s = stacked["scaler"]
    h = (xb - s["x_mean"][:, None, :]) / s["x_std"][:, None, :]
    layers = stacked["net"]["layers"]
    for layer in layers[:-1]:
        h = torch.relu(torch.bmm(h, layer["w"]) + layer["b"][:, None, :])
    out = torch.bmm(h, layers[-1]["w"]) + layers[-1]["b"][:, None, :]
    return out[:, :, 0] * s["y_std"][:, None] + s["y_mean"][:, None]


class StackedMLPPredictor:
    """Score N same-architecture tenants' MLPs in one device dispatch.

    ``capacity`` is the stack budget (slots), fixed for the predictor's
    life: every bucket's program is built at ``[capacity, bucket,
    features]``, so residency churn never builds one. ``canary_slots`` of
    that capacity are reserved for ``admit(..., canary=True)``.
    ``row_budget`` bounds rows per tenant per dispatch (None: the largest
    bucket). ``device`` is the card unless the caller asks for the CPU.
    ``builds`` counts programs built (``captures`` those captured on the
    card) and ``replays`` the graph replays."""

    dtype = "float32"

    def __init__(
        self,
        capacity: int,
        buckets: tuple[int, ...] = DEFAULT_STACK_BUCKETS,
        stack_mode: str = "scan",
        canary_slots: int = 0,
        row_budget: int | None = None,
        device=None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if stack_mode not in STACK_MODES:
            raise ValueError(
                f"unknown stack_mode {stack_mode!r} (want one of {STACK_MODES})"
            )
        if not 0 <= canary_slots < capacity:
            raise ValueError(
                f"canary_slots must leave at least one regular slot "
                f"(capacity={capacity}, canary_slots={canary_slots})"
            )
        self.capacity = capacity
        self.buckets = tuple(sorted(buckets))
        self.stack_mode = stack_mode
        self.canary_slots = canary_slots
        self.row_budget = row_budget if row_budget else self.buckets[-1]
        self.device = resolve_device(device)
        require_ieee_f32_matmul(self.device)
        self._lock = threading.RLock()
        #: tenant -> slot index, in LRU order (oldest first)
        self._slots: OrderedDict[str, int] = OrderedDict()
        self._canary: set[str] = set()
        self._occupied = [False] * capacity
        self._arch_digest = None
        self._n_features: int | None = None
        #: the stacked params: one ``[capacity, ...]`` tensor per leaf,
        #: allocated at the first admission and only written in place after
        self._stacked = None
        self._programs: dict[int, _CapturedProgram] = {}
        self.builds = self.captures = self.replays = 0
        self._metrics = None

    # -- residency ---------------------------------------------------------
    def _obs(self):
        if self._metrics is None:
            self._metrics = _tenancy_metrics()
        return self._metrics

    def resident(self) -> tuple[str, ...]:
        """Resident tenants, LRU-oldest first."""
        with self._lock:
            return tuple(self._slots)

    def is_resident(self, tenant_id: str) -> bool:
        with self._lock:
            return tenant_id in self._slots

    def _slot_budget(self, canary: bool) -> int:
        return self.canary_slots if canary else self.capacity - self.canary_slots

    def admit(self, tenant_id: str, model, canary: bool = False) -> int:
        """Give ``tenant_id`` a stack slot holding ``model``'s params,
        evicting the least recently used tenant of the same class
        (regular or canary) when that class's slots are full; returns the
        slot index. A resident tenant's params are refreshed in place.
        Raises :class:`StackNotCompatible` for a model that is not a
        fitted MLP of the stack's architecture."""
        validate_tenant_id(tenant_id)
        if not isinstance(model, MLPRegressor):
            raise StackNotCompatible(f"stacked serving is MLP-only; got {model.info}")
        if model.params is None:
            raise StackNotCompatible(
                f"tenant {tenant_id!r} model is unfitted (params=None) "
                "— did you drop fit()'s return value?"
            )
        params = model.params
        digest = _arch_digest(params)
        with self._lock:
            if self._arch_digest is None:
                self._arch_digest = digest
                self._n_features = model.n_features or 1
                self._stacked = _tree_map(
                    lambda t: torch.zeros((self.capacity,) + tuple(t.shape), dtype=t.dtype,
                                          device=self.device), params)
            elif digest != self._arch_digest:
                raise StackNotCompatible(
                    f"tenant {tenant_id!r} params architecture differs "
                    "from the resident stack's (same-arch stacking only)"
                )
            if tenant_id in self._slots:
                slot = self._slots[tenant_id]
                self._slots.move_to_end(tenant_id)
                self._canary.discard(tenant_id)
                if canary:
                    self._canary.add(tenant_id)
                self._write_slot(slot, params)
                return slot
            peers = [t for t in self._slots if (t in self._canary) == canary]
            if len(peers) >= self._slot_budget(canary):
                slot = self._evict_locked(peers[0])  # LRU-oldest first
            else:
                slot = self._occupied.index(False)
            self._slots[tenant_id] = slot
            self._occupied[slot] = True
            if canary:
                self._canary.add(tenant_id)
            self._write_slot(slot, params)
            self._obs()[4].set(len(self._slots))
            return slot

    def evict(self, tenant_id: str) -> None:
        """Free ``tenant_id``'s slot (a no-op when it is not resident)."""
        with self._lock:
            if tenant_id in self._slots:
                self._evict_locked(tenant_id)
                self._obs()[4].set(len(self._slots))

    def _evict_locked(self, tenant_id: str) -> int:
        slot = self._slots.pop(tenant_id)
        self._occupied[slot] = False
        self._canary.discard(tenant_id)
        self._write_slot(slot, None)
        self._obs()[2].inc(tenant=tenant_id)
        log.info(f"evicted tenant {tenant_id!r} from stack slot {slot}")
        return slot

    def _write_slot(self, slot: int, params) -> None:
        """Copy ``params`` into slot ``slot`` of the stacked tensors, or
        zero-fill it for None: data movement into the tensors every
        captured graph reads, never a new allocation."""
        with torch.no_grad():
            if params is None:
                for leaf in _leaves(self._stacked):
                    leaf[slot].zero_()
            else:
                for leaf, value in zip(_leaves(self._stacked), _leaves(params)):
                    leaf[slot].copy_(value)

    # -- the stacked program ----------------------------------------------
    def _runner(self):
        stacked = self._stacked
        if self.stack_mode == "vmap":
            return lambda xb: _vmap_apply(stacked, xb)
        views = [_tree_map(lambda t, i=i: t[i], stacked) for i in range(self.capacity)]
        return lambda xb: torch.stack([mlp_apply(v, xb[i]) for i, v in enumerate(views)])

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _program_for(self, bucket: int) -> _CapturedProgram:
        program = self._programs.get(bucket)
        if program is None:
            shape = (self.capacity, bucket, self._n_features or 1)
            with _CAPTURE_LOCK:
                program = _CapturedProgram(self._runner(), shape, self.device)
            self._programs[bucket] = program
            self.builds += 1
            self.captures += program.graph is not None
        return program

    def _dispatch(self, Xb: np.ndarray) -> np.ndarray:
        program = self._program_for(Xb.shape[1])
        out = program.run(Xb)
        self.replays += program.graph is not None
        return out

    def warmup(self) -> None:
        """Build every bucket's program (a capture on the card) and run it
        once before taking traffic. Needs one admitted tenant (the
        architecture is learned at the first admission)."""
        with self._lock:
            if self._stacked is None:
                raise TenantNotResident("warmup needs at least one admitted tenant")
            n_features = self._n_features or 1
            for b in self.buckets:
                self._dispatch(np.zeros((self.capacity, b, n_features), dtype=np.float32))
        log.info(
            f"warmed stacked buckets {self.buckets} "
            f"(capacity={self.capacity}, mode={self.stack_mode})"
        )

    def stats(self) -> dict:
        with self._lock:
            return {"builds": self.builds, "captures": self.captures,
                    "replays": self.replays, "resident": len(self._slots)}

    # -- dispatch ----------------------------------------------------------
    def predict_multi(self, batches: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Score every tenant's rows in one device dispatch.

        ``batches`` maps resident tenant ids to their rows (``[n,
        features]`` or ``[n]``). Raises :class:`TenantNotResident` for a
        tenant without a slot and :class:`TenantOverBudget` for one over
        its sub-budget, both before any device work."""
        if not batches:
            return {}
        rows_c, dispatch_c, _, rejected_c, _ = self._obs()
        with self._lock:
            if self._stacked is None:
                raise TenantNotResident(
                    f"no tenants resident; admit before dispatch: {sorted(batches)}"
                )
            n_features = self._n_features or 1
            prepared: dict[str, np.ndarray] = {}
            max_rows = 1
            for tenant_id, X in batches.items():
                if tenant_id not in self._slots:
                    raise TenantNotResident(
                        f"tenant {tenant_id!r} not resident "
                        f"(resident: {sorted(self._slots)})"
                    )
                X = np.asarray(X, dtype=np.float32)
                if X.ndim == 1:
                    X = X[:, None]
                if X.shape[0] > self.row_budget:
                    rejected_c.inc(amount=X.shape[0] - self.row_budget, tenant=tenant_id)
                    raise TenantOverBudget(
                        f"tenant {tenant_id!r}: {X.shape[0]} rows exceeds "
                        f"the per-tenant sub-budget ({self.row_budget})"
                    )
                prepared[tenant_id] = X
                max_rows = max(max_rows, X.shape[0])
            bucket = self._bucket_for(max_rows)
            Xb = np.zeros((self.capacity, bucket, n_features), dtype=np.float32)
            for tenant_id, X in prepared.items():
                Xb[self._slots[tenant_id], : X.shape[0]] = X
            out = self._dispatch(Xb)
            results = {}
            for tenant_id, X in prepared.items():
                results[tenant_id] = out[self._slots[tenant_id], : X.shape[0]]
                self._slots.move_to_end(tenant_id)
                rows_c.inc(amount=X.shape[0], tenant=tenant_id)
            dispatch_c.inc()
            return results

    def predict(self, tenant_id: str, X: np.ndarray) -> np.ndarray:
        """Single-tenant convenience over :meth:`predict_multi`."""
        return self.predict_multi({tenant_id: X})[tenant_id]
