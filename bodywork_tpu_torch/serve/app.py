"""The scoring application (the port of ``bodywork_tpu.serve.app``, cut to
the serving slice): plain Python over the standard library, no WSGI.

Routes, in the JAX app's wire format (the same keys in the same order;
for the same float predictions, the same bytes):

- ``POST /score/v1``  ``{"X": 50}`` -> ``{"prediction", "model_info", "model_date"}``
- ``POST /score/v1/batch`` ``{"X": [...]}`` -> ``{"predictions", "n", "model_info", "model_date"}``
- ``GET /healthz`` -> status and the served model's identity, plus the
  port's ``engine``, ``device`` and the serving kernel's ``launches``.

Malformed requests answer 400 with the JAX app's messages; unknown routes
404 and wrong methods 405 with werkzeug's descriptions; an unhandled
error 500 ``{"error": "internal server error"}``.

Every scoring path runs the prediction-sanity firewall before it
serialises a prediction (the production branch of the JAX app's,
``bodywork_tpu/serve/app.py:137-170,697-717``): a non-finite prediction
raises :class:`PredictionSanityError` and the request answers 500, the
value never written; a prediction outside the model's registry band
(``prediction_bounds``, from its training labels) is logged and served,
since the band is statistical. The canary, coalescer, admission control,
tracing and ``/metrics`` wait for later slices.
"""
from __future__ import annotations

import json

import numpy as np

from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES
from bodywork_tpu_torch.serve.wire import (
    BatchResponseTemplate,
    SingleResponseTemplate,
    parse_features,
)
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.app")

_NOT_FOUND = (
    "The requested URL was not found on the server. If you entered the URL "
    "manually please check your spelling and try again."
)
_METHOD_NOT_ALLOWED = "The method is not allowed for the requested URL."
_JSON = {"Content-Type": "application/json"}


class PredictionSanityError(RuntimeError):
    """A production prediction failed the sanity firewall (non-finite).
    There is no healthier model to answer from, so the request fails
    (500) rather than serialise garbage to the client."""


def as_bounds(bounds) -> tuple[float, float] | None:
    """A registry ``prediction_bounds`` value (``{"lo", "hi"}`` or a
    ``(lo, hi)`` pair) as a float pair; None when absent or malformed (the
    firewall then checks finiteness only)."""
    if bounds is None:
        return None
    try:
        if isinstance(bounds, dict):
            lo, hi = float(bounds["lo"]), float(bounds["hi"])
        else:
            lo, hi = float(bounds[0]), float(bounds[1])
    except (KeyError, IndexError, TypeError, ValueError):
        return None
    if not (np.isfinite(lo) and np.isfinite(hi) and lo <= hi):
        return None
    return lo, hi


def sanity_violation(predictions, bounds: tuple[float, float] | None) -> str | None:
    """The firewall's verdict on one response's predictions:
    ``"non_finite"`` (NaN or inf anywhere), ``"out_of_range"`` (outside
    ``bounds``) or None (sane)."""
    arr = np.asarray(predictions, dtype=np.float64)
    if not np.all(np.isfinite(arr)):
        return "non_finite"
    if bounds is not None:
        lo, hi = bounds
        if np.any(arr < lo) or np.any(arr > hi):
            return "out_of_range"
    return None


def _json_response(payload: dict, status: int = 200):
    return status, dict(_JSON), json.dumps(payload).encode()


def _is_json(content_type: str | None) -> bool:
    mimetype = (content_type or "").split(";", 1)[0].strip().lower()
    return mimetype == "application/json" or (
        mimetype.startswith("application/") and mimetype.endswith("+json")
    )


class _Served:
    """One served model: predictor + identity, read once per request."""

    __slots__ = (
        "predictor", "model_info", "model_date", "model_key", "source",
        "bounds", "single_template", "batch_template",
    )

    def __init__(self, predictor, model_info: str, model_date: str | None,
                 model_key: str | None = None, source: str | None = None,
                 bounds: tuple[float, float] | None = None):
        self.predictor = predictor
        self.model_info = model_info
        self.model_date = model_date
        self.model_key = model_key
        self.source = source
        #: (lo, hi) prediction-sanity band from the model's registry record
        self.bounds = bounds
        self.single_template = SingleResponseTemplate(model_info, model_date)
        self.batch_template = BatchResponseTemplate(model_info, model_date)


class ScoringApp:
    """Scoring application over a shape-bucketed predictor. :meth:`handle`
    maps one request to ``(status, headers, body)``; the HTTP server
    (``serve.server``) only moves bytes."""

    def __init__(self, model, model_date=None, predictor=None,
                 model_key: str | None = None, model_source: str | None = None,
                 model_bounds=None):
        if predictor is None:
            from bodywork_tpu_torch.serve.predictor import PaddedPredictor

            predictor = PaddedPredictor(model)
        self.served = _Served(
            predictor, model.info, str(model_date) if model_date else None,
            model_key=model_key, source=model_source, bounds=as_bounds(model_bounds),
        )
        self._routes = {
            ("POST", "/score/v1"): self.score_data_instance,
            ("POST", "/score/v1/batch"): self.score_batch,
            ("GET", "/healthz"): self.healthz,
        }

    @property
    def predictor(self):
        return self.served.predictor

    def handle(self, method: str, path: str, body: bytes = b"",
               content_type: str | None = None):
        path = path.split("?", 1)[0]
        handler = self._routes.get((method, path))
        if handler is None:
            if any(p == path for _m, p in self._routes):
                return _json_response({"error": _METHOD_NOT_ALLOWED}, 405)
            return _json_response({"error": _NOT_FOUND}, 404)
        try:
            return handler(body, content_type)
        except Exception as exc:  # don't leak tracebacks to clients
            log.error(f"unhandled error serving {path}: {exc!r}")
            return _json_response({"error": "internal server error"}, 500)

    @staticmethod
    def _parse(body: bytes, content_type: str | None):
        payload = None
        if _is_json(content_type):
            try:
                payload = json.loads(body)
            except ValueError:
                payload = None
        X, message = parse_features(payload)
        if message is not None:
            return None, _json_response({"error": message}, 400)
        return X, None

    def score_data_instance(self, body: bytes, content_type: str | None):
        """Single-instance scoring; reference-parity contract
        (``stage_2:73-80``)."""
        X, err = self._parse(body, content_type)
        if err is not None:
            return err
        served = self.served
        X = np.array(X, ndmin=2)  # scalar -> (1, 1), as the reference
        prediction0 = float(np.asarray(served.predictor.predict(X)).ravel()[0])
        self.firewall(served, prediction0)
        return 200, dict(_JSON), served.single_template.render(prediction0)

    def score_batch(self, body: bytes, content_type: str | None):
        """Batched scoring: one padded device call per bucket-size chunk."""
        X, err = self._parse(body, content_type)
        if err is not None:
            return err
        served = self.served
        if X.ndim == 0:
            X = X[None]
        predictions = served.predictor.predict(X)
        self.firewall(served, predictions)
        return 200, dict(_JSON), served.batch_template.render(predictions)

    @staticmethod
    def firewall(served: _Served, predictions) -> None:
        """The prediction-sanity firewall, before serialisation: a
        non-finite prediction raises :class:`PredictionSanityError` (500);
        one outside the model's band is logged and served."""
        reason = sanity_violation(predictions, served.bounds)
        if reason == "non_finite":
            log.error(f"production prediction non-finite on {served.model_key}; "
                      "refusing to serialize")
            raise PredictionSanityError(reason)
        if reason is not None:
            log.warning(f"production prediction out of sanity band on "
                        f"{served.model_key} (served anyway; band is statistical)")

    def healthz_payload(self) -> dict:
        served = self.served
        predictor = served.predictor
        engine = getattr(predictor, "engine", "torch")
        return {
            "status": "ok",
            "model_info": served.model_info,
            "model_date": served.model_date,
            "model_key": served.model_key,
            "model_source": served.source,
            "serving_dtype": getattr(predictor, "dtype", "float32"),
            "engine": engine,
            "device": predictor.device.type,
            # launches of the serving kernel variant since the counts were
            # last reset (null for the torch engine, which has no kernel)
            "launches": LAUNCHES.get(engine),
        }

    def healthz(self, body: bytes, content_type: str | None):
        return _json_response(self.healthz_payload())
