"""Flaky scoring-service mode: probabilistic 503/429/latency on /score/v1*
(the port's copy of ``bodywork_tpu.chaos.http``).

:class:`FlakyScoringMiddleware` wraps a scoring app's ``handle`` (the
in-process interface the test stage's ``InProcessScoringClient`` scores
through, where the JAX package wraps the WSGI app) and consults the fault
plan once per scoring request, on the same decision streams: it injects
latency, answers a 503/429 with a ``Retry-After`` header (the hint the
scoring client must honour), or passes the request through. Health,
metrics and every other route always pass through: the harness breaks
the data path, not the probes that see the breakage. Injected refusals
count as ``bodywork_tpu_serve_shed_total{reason="chaos"}``.

:func:`flaky_serve_stage` is the chaos simulation's drop-in for the
canonical serve stage: it starts the real service, then wraps the
handle's in-process app in the middleware. The socket-facing server
keeps serving the unwrapped app.
"""
from __future__ import annotations

import json

from bodywork_tpu_torch.chaos.plan import FaultPlan, get_active_plan
from bodywork_tpu_torch.serve.httpcore import LocalClient
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("chaos.http")

__all__ = ["FlakyScoringMiddleware", "flaky_serve_stage"]


class FlakyScoringMiddleware:
    def __init__(self, app, plan: FaultPlan):
        self._app = app
        self.plan = plan

    def handle(self, method: str, path: str, body: bytes = b"",
               content_type: str | None = None, traceparent: str | None = None):
        if path.startswith("/score/v1"):
            self.plan.http_latency(path)
            status = self.plan.http_error(path)
            if status is not None:
                from bodywork_tpu_torch.serve.admission import count_shed

                count_shed("chaos")
                return status, {
                    "Content-Type": "application/json",
                    "Retry-After": str(self.plan.http_retry_after_s),
                }, json.dumps({"error": f"injected fault: HTTP {status}"}).encode()
        return self._app.handle(method, path, body, content_type, traceparent=traceparent)

    def test_client(self) -> LocalClient:
        """An in-process client through the injected faults (the wrapped
        app's own client would bypass them)."""
        return LocalClient(self)

    def __getattr__(self, name):
        # everything but the request path (healthz payloads, swaps, close)
        # is the wrapped app's
        return getattr(self._app, name)


def flaky_serve_stage(ctx, **args):
    """The canonical serve stage with the active fault plan's flaky mode
    over the in-process scoring path (``chaos.sim.chaos_pipeline_spec``)."""
    from bodywork_tpu_torch.pipeline.stages import serve_stage

    handle = serve_stage(ctx, **args)
    plan = get_active_plan()
    if plan is not None:
        handle.app = FlakyScoringMiddleware(handle.app, plan)
        log.info(f"flaky scoring mode armed (p_error={plan.http_error_p}, "
                 f"p_latency={plan.http_latency_p})")
    return handle
