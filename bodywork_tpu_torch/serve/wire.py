"""The scoring service's wire formats (a copy of the part of
``bodywork_tpu.serve.wire`` the serving slice uses): request validation,
the binary row framing, and the response templates.

Byte-identity is the contract: request validation answers with the same
messages, a JSON request and its binary twin parse to the same array,
and for the same float predictions both packages' scoring responses are
the same bytes — ``json.dumps`` default separators, key order
``prediction, model_info, model_date`` (single) and ``predictions, n,
model_info, model_date`` (batch).
"""
from __future__ import annotations

import json
import struct

import numpy as np

__all__ = [
    "BINARY_CONTENT_TYPE",
    "MODEL_KEY_HEADER",
    "WIRE_SCHEMA_VERSION",
    "BatchResponseTemplate",
    "SingleResponseTemplate",
    "batch_score_payload",
    "encode_binary_rows",
    "parse_binary_rows",
    "parse_features",
    "single_score_payload",
]

#: response header naming the checkpoint that answered a scoring request
#: (headers are outside the frozen JSON body contract)
MODEL_KEY_HEADER = "X-Bodywork-Model-Key"

#: request content type of the binary row framing (JSON stays the
#: default): a little-endian ``u32 n_rows, u32 n_features`` header, then
#: ``n_rows * n_features`` little-endian f32s. Responses stay JSON.
BINARY_CONTENT_TYPE = "application/x-bodywork-rows"

#: version of that framing; bumped on any change to the header or the
#: row encoding
WIRE_SCHEMA_VERSION = 1

#: the binary header: little-endian (n_rows, n_features)
_BINARY_HEADER = struct.Struct("<II")


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


def encode_binary_rows(X) -> bytes:
    """A feature array as a binary row-batch request body. 1-D input is
    framed as ``(n_rows, 1)``, the shape the JSON path's ``{"X": [a, b]}``
    gives, so a JSON request and its binary twin parse to the same
    array."""
    arr = np.asarray(X, dtype="<f4")
    if arr.ndim == 0:
        arr = arr[None]
    if arr.ndim == 1:
        n_rows, n_features = arr.shape[0], 1
    elif arr.ndim == 2:
        n_rows, n_features = arr.shape
    else:
        raise ValueError(f"need 1-D or 2-D features, got shape {arr.shape}")
    return _BINARY_HEADER.pack(n_rows, n_features) + np.ascontiguousarray(arr).tobytes()


def parse_binary_rows(body: bytes):
    """A binary row-batch body as a float32 feature array: the
    ``(X, None) | (None, error_message)`` contract of
    :func:`parse_features`, with its messages for an empty or non-finite
    ``X``. ``n_features == 1`` decodes to a 1-D array, as the JSON path's
    flat list does."""
    if len(body) < _BINARY_HEADER.size:
        return None, "binary body too short for the row header"
    n_rows, n_features = _BINARY_HEADER.unpack_from(body)
    expected = _BINARY_HEADER.size + n_rows * n_features * 4
    if n_features < 1 or n_rows < 1:
        return None, "'X' must be non-empty"
    if len(body) != expected:
        return None, (
            f"binary body length mismatch: header says {n_rows}x"
            f"{n_features} rows ({expected} bytes), got {len(body)}"
        )
    X = np.frombuffer(body, dtype="<f4", offset=_BINARY_HEADER.size).astype(
        np.float32, copy=False
    )
    if n_features > 1:
        X = X.reshape(n_rows, n_features)
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
