"""Model checkpointing in the JAX package's npz format (the port of
``bodywork_tpu.models.checkpoint``).

A checkpoint is one ``.npz`` holding every params leaf under its tree
path (``net/layers/0/w``, ..., ``scaler/y_std``, in the JAX package's
sorted-key flatten order) plus a ``__meta__`` JSON blob (model type,
config, framework version). The format is framework-neutral: a checkpoint
written by either package loads and scores in the other.
"""
from __future__ import annotations

import io
import json
from datetime import date

import numpy as np

from bodywork_tpu_torch.device import resolve_device
from bodywork_tpu_torch.models.linear import LinearRegressor
from bodywork_tpu_torch.models.mlp import MLPRegressor, params_from_jax, params_to_host
from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore
from bodywork_tpu_torch.store.schema import MODELS_PREFIX, REGISTRY_RECORDS_PREFIX, model_key
from bodywork_tpu_torch.utils.dates import date_from_key
from bodywork_tpu_torch.utils.logging import get_logger
from bodywork_tpu_torch.version import __version__

log = get_logger("models.checkpoint")

_META_KEY = "__meta__"

#: checkpoint model type -> model class (the JAX package's registry)
MODEL_REGISTRY = {cls.model_type: cls for cls in (LinearRegressor, MLPRegressor)}


def _flatten(node, prefix: str = ""):
    """(path, leaf) pairs in the JAX pytree flatten order: dict keys
    sorted, list items by index."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _flatten(node[k], f"{prefix}{k}/")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], node


def save_model_bytes(model) -> bytes:
    """Serialise a model to npz bytes."""
    arrays = dict(_flatten(params_to_host(model.params)))
    meta = {
        "model_type": model.model_type,
        "config": model.config_dict(),
        "framework_version": __version__,
    }
    buf = io.BytesIO()
    np.savez(buf, **arrays, **{_META_KEY: np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)})
    return buf.getvalue()


def _listify(node):
    """Convert dict nodes whose keys are 0..n-1 back into lists."""
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node) and sorted(
            int(k) for k in node
        ) == list(range(len(node))):
            return [_listify(node[str(i)]) for i in range(len(node))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def _unflatten_paths(arrays: dict[str, np.ndarray]):
    root: dict = {}
    for path, arr in arrays.items():
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return _listify(root)


def load_model_bytes(data: bytes, device=None):
    """Reconstruct a model from npz bytes, its params on ``device`` (the
    card unless asked for the CPU)."""
    with np.load(io.BytesIO(data)) as npz:
        meta = json.loads(bytes(npz[_META_KEY]).decode())
        arrays = {k: npz[k] for k in npz.files if k != _META_KEY}
    model_type = meta["model_type"]
    cls = MODEL_REGISTRY.get(model_type)
    if cls is None:
        raise ValueError(
            f"unknown checkpoint model type {model_type!r}; expected one of "
            f"{sorted(MODEL_REGISTRY)}"
        )
    params = params_from_jax(_unflatten_paths(arrays), resolve_device(device))
    return cls.from_config_dict(meta["config"], params)


def save_model(store: ArtefactStore, model, artefact_date: date,
               data: bytes | None = None) -> str:
    """Persist a model under ``models/regressor-<date>.npz``."""
    key = model_key(artefact_date)
    store.put_bytes(key, data if data is not None else save_model_bytes(model))
    log.info(f"persisted {model.info} to {key}")
    return key


def resolve_serving_key(store: ArtefactStore) -> tuple[str, str]:
    """The (key, source) serving loads with no explicit key, as the JAX
    package resolves it (``bodywork_tpu/models/checkpoint.py:116-162``):

    - a store with an active registry (an alias document) serves the
      ``production`` alias, so only gate-promoted checkpoints take
      traffic; source ``"production"``;
    - otherwise the newest date-keyed checkpoint under ``models/`` that
      the gate has not rejected (a store whose first candidates failed
      the gate must not serve them); source ``"latest"``. On a store
      without registry records that is the newest checkpoint.

    No serviceable checkpoint raises :class:`ArtefactNotFound`; a corrupt
    alias document raises :class:`~bodywork_tpu_torch.registry.RegistryCorrupt`
    rather than fall back to the ungated latest checkpoint."""
    from bodywork_tpu_torch.registry.records import load_record, resolve_alias

    key = resolve_alias(store, "production")
    if key is not None:
        return key, "production"
    hist = store.history(MODELS_PREFIX)
    if not hist:
        raise ArtefactNotFound(f"no date-keyed artefacts under '{MODELS_PREFIX}'")
    if not store.list_keys(REGISTRY_RECORDS_PREFIX):
        return hist[-1][0], "latest"
    for candidate_key, _d in reversed(hist):
        record = load_record(store, candidate_key)
        if record is not None and record.get("status") == "rejected":
            log.info(f"skipping gate-rejected checkpoint {candidate_key} in "
                     "latest-fallback resolution")
            continue
        return candidate_key, "latest"
    raise ArtefactNotFound(
        f"every checkpoint under '{MODELS_PREFIX}' was gate-rejected "
        "and none was ever promoted"
    )


def load_model(store: ArtefactStore, key: str | None = None, device=None):
    """Load a model by key (default: :func:`resolve_serving_key`).
    Returns (model, artefact_date)."""
    if key is None:
        key, _source = resolve_serving_key(store)
    d = date_from_key(key)
    model = load_model_bytes(store.get_bytes(key), device=device)
    log.info(f"loaded {model.info} from {key} (trained {d})")
    return model, d
