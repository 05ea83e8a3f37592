"""The scoring service's wire formats (a copy of the part of
``bodywork_tpu.serve.wire`` the serving slice uses).

Byte-identity is the contract: request validation answers with the same
messages, and for the same float predictions both packages' scoring
responses are the same bytes — ``json.dumps`` default separators, key
order ``prediction, model_info, model_date`` (single) and ``predictions,
n, model_info, model_date`` (batch).
"""
from __future__ import annotations

import json

import numpy as np

__all__ = [
    "MODEL_KEY_HEADER",
    "BatchResponseTemplate",
    "SingleResponseTemplate",
    "batch_score_payload",
    "parse_features",
    "single_score_payload",
]

#: response header naming the checkpoint that answered a scoring request
#: (headers are outside the frozen JSON body contract)
MODEL_KEY_HEADER = "X-Bodywork-Model-Key"


def parse_features(payload):
    """Validate a decoded request body into a float32 feature array.
    Returns ``(X, None)`` or ``(None, error_message)``."""
    if not isinstance(payload, dict) or "X" not in payload:
        return None, "request body must be a JSON object with an 'X' field"
    try:
        X = np.asarray(payload["X"], dtype=np.float32)
    except (TypeError, ValueError):
        return None, "'X' must be numeric"
    if X.size == 0:
        return None, "'X' must be non-empty"
    if not np.all(np.isfinite(X)):
        return None, "'X' must be finite"
    return X, None


def single_score_payload(served, prediction0: float) -> dict:
    """The ``/score/v1`` response body."""
    return {
        "prediction": prediction0,
        "model_info": served.model_info,
        "model_date": served.model_date,
    }


def batch_score_payload(served, predictions) -> dict:
    """The ``/score/v1/batch`` response body."""
    return {
        "predictions": [float(p) for p in predictions],
        "n": int(len(predictions)),
        "model_info": served.model_info,
        "model_date": served.model_date,
    }


class SingleResponseTemplate:
    """Pre-serialized framing for the single-row 200 response: the body's
    invariant bytes are fixed per served model, so only the prediction is
    serialized per response. ``render`` is byte-identical to
    ``json.dumps(single_score_payload(served, p))``."""

    __slots__ = ("prefix", "suffix")

    def __init__(self, model_info, model_date):
        self.prefix = b'{"prediction": '
        self.suffix = (
            ", \"model_info\": " + json.dumps(model_info)
            + ", \"model_date\": " + json.dumps(model_date) + "}"
        ).encode()

    def render(self, prediction0: float) -> bytes:
        return self.prefix + json.dumps(prediction0).encode() + self.suffix


class BatchResponseTemplate:
    """:class:`SingleResponseTemplate`'s shape for the batch body;
    byte-identical to ``json.dumps(batch_score_payload(served, p))``."""

    __slots__ = ("prefix", "suffix")

    def __init__(self, model_info, model_date):
        self.prefix = b'{"predictions": '
        self.suffix = (
            ", \"model_info\": " + json.dumps(model_info)
            + ", \"model_date\": " + json.dumps(model_date) + "}"
        ).encode()

    def render(self, predictions) -> bytes:
        floats = [float(p) for p in predictions]
        return (
            self.prefix
            + json.dumps(floats).encode()
            + b', "n": ' + str(len(floats)).encode()
            + self.suffix
        )
