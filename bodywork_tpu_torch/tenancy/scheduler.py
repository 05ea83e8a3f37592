"""Fair scheduling of per-tenant retrain jobs (the port's copy of
``bodywork_tpu.tenancy.scheduler``, the same order).

One device pool retrains the whole fleet; without an explicit policy the
tenant that happens to sort first (or shout loudest) would starve the
rest. :class:`FairScheduler` is deliberately simple and deterministic —
round-robin over tenants with a persistent rotating head — because the
fleet sim's byte-identity proofs require the schedule to be a pure
function of (tenant set, tick), never of wall clock or arrival jitter.

Torch-free; the runner and the cli import it freely.
"""
from __future__ import annotations


class FairScheduler:
    """Deterministic round-robin over a (possibly changing) tenant set.

    Each call to :meth:`order` returns every due tenant exactly once,
    with the head of the line advancing one position per tick — so over
    any window of N ticks, each of N tenants goes first exactly once
    (no tenant's retrain systematically lands last, where a budget or
    deadline overrun would hit it). Tenants admitted mid-flight join in
    sorted position and inherit the rotation; departed tenants drop out
    without disturbing the others' relative order.
    """

    def __init__(self) -> None:
        self._tick = 0

    def order(self, tenants) -> list[str]:
        """The service order for this tick; advances the rotation."""
        ring = sorted(set(tenants))
        if not ring:
            return []
        k = self._tick % len(ring)
        self._tick += 1
        return ring[k:] + ring[:k]

    def peek(self, tenants) -> list[str]:
        """The order :meth:`order` WOULD return, without advancing."""
        ring = sorted(set(tenants))
        if not ring:
            return []
        k = self._tick % len(ring)
        return ring[k:] + ring[:k]
