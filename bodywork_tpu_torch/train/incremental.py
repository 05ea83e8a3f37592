"""Incremental training: an O(tail) daily retrain instead of O(history)
(the port of ``bodywork_tpu.train.incremental``).

**Linear: exact.** The OLS fit is the normal equations over ``A = [X |
1]``, and their statistics add over row blocks: ``G = Σ_day G_day``,
``c = Σ_day c_day`` (:func:`~bodywork_tpu_torch.models.linear.gram_stats`).
The running float64 sums, with a few scalars a day (row counts and the
label range, for staleness checks and the prediction-sanity band), live
in one digest-checked ``trainstate/`` document
(:func:`~bodywork_tpu_torch.store.schema.trainstate_key`), so a retrain
folds in only the new days' rows and solves in closed form on the host.
Each day's train/test membership is seeded by ``(seed, day)``
(:func:`day_split_indices`), so it never changes as history grows, and the
held-out metrics come from the tail window's test rows.

**MLP: approximate.** The net has no finite statistics: the retrain warm-
starts from the checkpoint serving would load (``resolve_serving_key``)
and fine-tunes it on the tail window's train rows
(:meth:`~bodywork_tpu_torch.models.mlp.MLPRegressor.fine_tune`), seeded
``seed + ordinal`` so every day draws fresh minibatches and both packages
draw the same ones. The result is a candidate like any other: the
runner's registry gate arms shadow evaluation for it
(:data:`INCREMENTAL_SHADOW_DAYS`), and a rejection triggers a full refit
the same day (``LocalRunner._full_refit_fallback``).

**Fallback, never a wedged pipeline.** Every incapacity degrades to the
full refit with its reason logged and recorded on
``TrainResult.fallback_reason``: ``no_donor``, ``donor_incompatible``,
``unsupported_model``, and for the linear path ``trainstate_absent``,
``trainstate_corrupt`` or ``trainstate_stale`` (then rebuilt from all
history in the same call). The runner adds ``gate_rejected``.

The document is a pure function of the dataset bytes and the split
parameters (sorted compact JSON, an embedded content digest), written
only through ``put_bytes_if_match``, so either package reads, folds onto
and rewrites the other's. Counters, the JAX package's:
``bodywork_tpu_train_fallbacks_total{reason}`` (:func:`count_fallback`,
which the runner's same-day refit calls too),
``bodywork_tpu_train_trainstate_corrupt_total`` (each invalid read), and
the ``bodywork_tpu_train_*`` family of every fit
(``trainer._record_train_metrics``, mode ``incremental``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from time import perf_counter

import numpy as np
import torch

from bodywork_tpu_torch.device import fence, require_ieee_f32_matmul, resolve_device
from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore, CasConflict
from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, trainstate_key
from bodywork_tpu_torch.train.trainer import TrainResult, _record_train_metrics, make_model
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("train.incremental")

TRAINSTATE_SCHEMA = "bodywork_tpu.trainstate/1"

#: tail window (days) for the linear held-out metrics and the MLP replay
TAIL_DAYS = 7

#: shadow-evaluation window the runner's gate arms for incremental
#: candidates: a degraded fine-tune is rejected there
INCREMENTAL_SHADOW_DAYS = 3

#: MLP fine-tune budget: this fraction of the config's n_steps, at least
#: MIN_FINE_TUNE_STEPS
FINE_TUNE_STEPS_FRACTION = 0.25
MIN_FINE_TUNE_STEPS = 100

#: trainstate reads: 1 + this many attempts before a document that stays
#: invalid counts as corrupt
CORRUPT_READ_RETRIES = 2


def count_fallback(reason: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_train_fallbacks_total",
        "Incremental-train degradations to a full refit, by reason",
    ).inc(reason=reason)


def _count_corrupt() -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_train_trainstate_corrupt_total",
        "Trainstate reads that failed JSON/schema/digest validation",
    ).inc()


class IncrementalUnavailable(RuntimeError):
    """The incremental path cannot run for a structural reason; the
    dispatcher degrades to a full refit recording ``reason``."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


# -- per-day deterministic splits ------------------------------------------


def day_split_indices(n: int, day, test_size: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(train_idx, test_idx)`` for one day's ``n`` rows, seeded by
    ``(seed, day)`` alone, so a day's membership is fixed forever: the
    first ``round(n * test_size)`` permuted indices are the test rows, as
    in the global split."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, day.toordinal())))
    perm = rng.permutation(n)
    n_test = int(round(n * test_size))
    return perm[n_test:], perm[:n_test]


def _window_eval_arrays(parts, window_keys, dates, test_size: float, seed: int):
    """The tail window's held-out rows (each day's test split), oldest
    first. A window whose test splits are all empty (tiny days) falls back
    to its full rows: an in-sample metric rather than a NaN that would
    wedge the gate."""
    Xs, ys = [], []
    for key in window_keys:
        ds = parts[key]
        _train_idx, test_idx = day_split_indices(len(ds), dates[key], test_size, seed)
        if len(test_idx):
            Xs.append(ds.X[test_idx])
            ys.append(ds.y[test_idx])
    if not Xs:
        Xs = [parts[k].X for k in window_keys]
        ys = [parts[k].y for k in window_keys]
    return np.concatenate(Xs), np.concatenate(ys)


# -- the trainstate document -----------------------------------------------


def _payload_digest(doc: dict) -> str:
    payload = json.dumps(
        [doc["model_type"], doc["feature_dim"], doc["split"],
         doc["cum_g"], doc["cum_c"], doc["days"]],
        sort_keys=True,
    ).encode("utf-8")
    return "sha256:" + hashlib.sha256(payload).hexdigest()


def _build_doc(model_type: str, feature_dim: int, split: dict, days: dict, cum_g, cum_c) -> dict:
    """The trainstate document: the running float64 sums over every
    covered day's train split, and per-day scalars only (an O(days)
    payload of Gram blocks would make the daily rewrite grow)."""
    doc = {
        "schema": TRAINSTATE_SCHEMA,
        "model_type": model_type,
        "feature_dim": int(feature_dim),
        "split": split,
        "days": days,
        "cum_g": [[float(v) for v in row] for row in cum_g],
        "cum_c": [float(v) for v in cum_c],
    }
    doc["digest"] = _payload_digest(doc)
    return doc


def read_trainstate(store: ArtefactStore, model_type: str):
    """``(doc, version_token, reason)``: ``doc`` is None when the key is
    absent (``"trainstate_absent"``) or stays invalid (schema or digest)
    past the retry budget (``"trainstate_corrupt"``; the token is kept so
    the rebuild's CAS overwrites it)."""
    key = trainstate_key(model_type)
    token = store.version_token(key)
    for _attempt in range(1 + CORRUPT_READ_RETRIES):
        try:
            raw = store.get_bytes(key)
        except ArtefactNotFound:
            return None, None, "trainstate_absent"
        try:
            doc = json.loads(raw.decode("utf-8"))
            if (
                isinstance(doc, dict)
                and doc.get("schema") == TRAINSTATE_SCHEMA
                and isinstance(doc.get("days"), dict)
                and isinstance(doc.get("cum_g"), list)
                and isinstance(doc.get("cum_c"), list)
                and doc.get("digest") == _payload_digest(doc)
            ):
                return doc, token, None
        except (UnicodeDecodeError, ValueError, KeyError, TypeError):
            pass
        _count_corrupt()
        log.warning(f"corrupt trainstate document at {key!r}; re-reading")
    return None, token, "trainstate_corrupt"


def persist_trainstate(store: ArtefactStore, model_type: str, doc: dict,
                       attempts: int = 4) -> str:
    """CAS-write one trainstate document, last writer wins: a lost race
    re-reads the token and overwrites. Two divergent sums are never
    merged; a day the final document does not cover reads as new on the
    next retrain and is folded back in. The only writer of
    ``trainstate/``."""
    key = trainstate_key(model_type)
    # compact separators, sorted keys: the JAX package's bytes
    data = json.dumps(doc, sort_keys=True, separators=(",", ":")).encode("utf-8")
    last: CasConflict | None = None
    for _attempt in range(attempts):
        try:
            store.put_bytes_if_match(key, data, store.version_token(key))
            return key
        except CasConflict as exc:
            last = exc  # a concurrent writer: re-read the token, retry
    raise last


# -- linear: exact sufficient statistics -----------------------------------


def _day_entry(ds, test_size: float, seed: int) -> dict:
    """One day's additive statistics: its train split's Gram blocks, and
    the full day's row count and label range (the band is over every row,
    as the full refit's)."""
    from bodywork_tpu_torch.models.linear import gram_stats

    X = np.asarray(ds.X, dtype=np.float64)
    y = np.asarray(ds.y, dtype=np.float64).ravel()
    train_idx, _test_idx = day_split_indices(len(y), ds.date, test_size, seed)
    G, c = gram_stats(X[train_idx], y[train_idx])
    return {
        "g": G.tolist(),
        "c": c.tolist(),
        "n_rows": int(len(y)),
        "n_train": int(len(train_idx)),
        "y_min": float(np.min(y)),
        "y_max": float(np.max(y)),
    }


def accumulate_entries(entries: dict, cum_g=None, cum_c=None):
    """Fold per-day :func:`_day_entry` statistics onto ``(G, c)`` in
    sorted-day order: sequential float64 sums, so a rebuild reproduces
    the grown sums bit for bit when days arrive in order, and within
    float tolerance in any order."""
    first = next(iter(entries.values()))
    dim = len(first["c"])
    G = np.zeros((dim, dim)) if cum_g is None else np.asarray(cum_g, dtype=np.float64).copy()
    c = np.zeros(dim) if cum_c is None else np.asarray(cum_c, dtype=np.float64).copy()
    for key in sorted(entries):
        G += np.asarray(entries[key]["g"], dtype=np.float64)
        c += np.asarray(entries[key]["c"], dtype=np.float64)
    return G, c


def solve_from_days(days: dict, config=None) -> dict:
    """Accumulate per-day statistics and solve the normal equations (host
    float32 params)."""
    from bodywork_tpu_torch.models.linear import solve_normal_eq

    return solve_normal_eq(*accumulate_entries(days), config)


def _bounds_from_days(days: dict) -> dict:
    """The prediction-sanity band from per-day label ranges: the full
    refit's band over all of history (a global min and max decompose
    over days)."""
    lo = min(e["y_min"] for e in days.values())
    hi = max(e["y_max"] for e in days.values())
    span = max(hi - lo, 1e-6)
    return {"lo": lo - 0.5 * span, "hi": hi + 0.5 * span}


def _load_parts(store: ArtefactStore, keys) -> dict:
    """The parsed datasets of ``keys`` (O(tail) days) through the history
    loader's three tiers (parse cache, snapshot slices, one batched
    fetch), the ones the full refit reads O(history) days through."""
    from bodywork_tpu_torch.data.io import load_history_parts
    from bodywork_tpu_torch.utils.dates import date_from_key

    subset = [(key, date_from_key(key)) for key in keys]
    return load_history_parts(store, subset, store.version_tokens(list(keys)))


def _stale_detail(doc: dict, days: dict, parts, tail_keys, dates, feature_dim: int):
    """Why the covered statistics no longer describe the store, or None:
    a feature-dimension change, or a covered tail day whose dataset was
    overwritten (row count or label range moved). Overwrites of pre-tail
    days that keep both are the known blind spot; a deleted day is
    caught before the read."""
    if doc.get("feature_dim") != feature_dim:
        return "feature dimension changed"
    for key in tail_keys:
        meta = days.get(str(dates[key]))
        if meta is None:
            continue
        y64 = np.asarray(parts[key].y, dtype=np.float64).ravel()
        if (meta.get("n_rows") != len(y64) or meta.get("y_min") != float(np.min(y64))
                or meta.get("y_max") != float(np.max(y64))):
            return f"covered day {dates[key]} was overwritten"
    return None


def incremental_train_linear(store: ArtefactStore, model_kwargs: dict | None = None,
                             test_size: float = 0.2, split_seed: int = 42,
                             tail_days: int = TAIL_DAYS, persist: bool = True,
                             device=None) -> TrainResult:
    """The exact incremental linear retrain: fold the days the trainstate
    does not cover, solve on the host in float64, evaluate the tail
    window's test rows on ``device``. An absent, corrupt or stale document
    is rebuilt from all history in the same call, with the reason on the
    result."""
    from bodywork_tpu_torch.models import LinearRegressor
    from bodywork_tpu_torch.models.linear import solve_normal_eq

    dev = resolve_device(device)
    require_ieee_f32_matmul(dev)
    model = make_model("linear", **(model_kwargs or {}))
    hist = store.history(DATASETS_PREFIX)
    if not hist:
        raise ArtefactNotFound(f"no datasets under '{DATASETS_PREFIX}'")
    dates = dict(hist)
    hist_keys = [k for k, _d in hist]
    split = {"test_size": test_size, "seed": split_seed}

    t0 = perf_counter()
    doc, _token, reason = read_trainstate(store, "linear")
    days: dict = {}
    cum_g = cum_c = None
    if doc is not None:
        if doc.get("split") != split or not set(doc["days"]) <= {str(d) for _k, d in hist}:
            # another split, or a covered day's dataset was deleted
            reason = "trainstate_stale"
        else:
            days = dict(doc["days"])
            cum_g, cum_c = doc["cum_g"], doc["cum_c"]
    tail_keys = hist_keys[-max(tail_days, 1):]
    new_keys = [k for k in hist_keys if str(dates[k]) not in days]
    needed = list(dict.fromkeys(new_keys + tail_keys))
    parts = _load_parts(store, needed)
    feature_dim = parts[needed[0]].X.shape[1]
    stale = _stale_detail(doc, days, parts, tail_keys, dates, feature_dim) if days else None
    if stale is not None:
        log.warning(f"linear trainstate stale ({stale}); rebuilding")
        reason = "trainstate_stale"
        days, cum_g, cum_c = {}, None, None
        new_keys = hist_keys
        parts = _load_parts(store, dict.fromkeys(new_keys + tail_keys))
    if reason is not None:
        count_fallback(reason)
        log.warning(f"linear trainstate {reason}: rebuilding the statistics from all "
                    f"{len(new_keys)} day(s) (a full-refit-cost day; the next is O(tail))")
    if new_keys:
        new_entries = {str(dates[k]): _day_entry(parts[k], test_size, split_seed)
                       for k in new_keys}
        cum_g, cum_c = accumulate_entries(new_entries, cum_g, cum_c)
        for day_str, entry in new_entries.items():
            days[day_str] = {k: entry[k] for k in ("n_rows", "n_train", "y_min", "y_max")}

    host = solve_normal_eq(cum_g, cum_c, model.config)
    fitted = LinearRegressor(model.config, {k: torch.as_tensor(v, device=dev)
                                            for k, v in host.items()})
    metrics = fitted.evaluate(*_window_eval_arrays(parts, tail_keys, dates, test_size,
                                                   split_seed))
    n_rows = sum(e["n_rows"] for e in days.values())
    rows_touched = sum(len(p) for p in parts.values())
    fence(fitted.params)
    _record_train_metrics(fitted, metrics, perf_counter() - t0, n_rows,
                          mode="incremental", rows_touched=rows_touched)
    log.info(f"incremental linear fold: {len(new_keys)} new day(s) into {len(days)} "
             f"covered, {rows_touched} rows touched of {n_rows} on {dev}: "
             f"MAPE={metrics['MAPE']:.4f} r2={metrics['r_squared']:.4f}")
    result = TrainResult(
        fitted, metrics, hist[-1][1], None, None, n_rows,
        prediction_bounds=_bounds_from_days(days), mode="incremental",
        rows_touched=rows_touched, fallback_reason=reason,
        pending_trainstate=_build_doc("linear", feature_dim, split, days, cum_g, cum_c),
    )
    if persist:
        from bodywork_tpu_torch.train.trainer import persist_train_result

        result = persist_train_result(store, result)
    return result


# -- mlp: warm start + replay ----------------------------------------------


def _load_donor(store: ArtefactStore, device):
    """The warm-start donor: the checkpoint serving would load, on
    ``device``. Any failure (no checkpoint, a corrupt alias, unreadable
    bytes) is an :class:`IncrementalUnavailable`."""
    from bodywork_tpu_torch.models.checkpoint import load_model

    try:
        model, _d = load_model(store, None, device=device)
        return model
    except Exception as exc:  # noqa: BLE001 - every failure degrades to a full refit
        raise IncrementalUnavailable(
            "no_donor", f"no donor checkpoint for warm start: {exc!r}") from exc


def incremental_train_mlp(store: ArtefactStore, model_kwargs: dict | None = None,
                          test_size: float = 0.2, split_seed: int = 42,
                          fit_seed: int | None = None, tail_days: int = TAIL_DAYS,
                          persist: bool = True, device=None) -> TrainResult:
    """The approximate incremental MLP retrain: warm-start from the
    serving checkpoint on ``device``, fine-tune it for ``max(100, n_steps /
    4)`` steps on the tail window's train rows, evaluate on the window's
    test rows. The runner gates it with shadow evaluation."""
    from bodywork_tpu_torch.train.trainer import _prediction_bounds

    dev = resolve_device(device)
    cfg = make_model("mlp", **(model_kwargs or {})).config
    hist = store.history(DATASETS_PREFIX)
    if not hist:
        raise ArtefactNotFound(f"no datasets under '{DATASETS_PREFIX}'")
    dates = dict(hist)
    data_date = hist[-1][1]

    t0 = perf_counter()
    donor = _load_donor(store, dev)
    if donor.model_type != "mlp":
        raise IncrementalUnavailable(
            "donor_incompatible", f"donor is {donor.model_type!r}, cannot warm-start an mlp")
    if tuple(donor.config.hidden) != tuple(cfg.hidden):
        raise IncrementalUnavailable(
            "donor_incompatible",
            f"donor hidden={list(donor.config.hidden)} != requested {list(cfg.hidden)}")
    window_keys = [k for k, _d in hist[-max(tail_days, 1):]]
    parts = _load_parts(store, window_keys)
    feature_dim = parts[window_keys[0]].X.shape[1]
    if donor.n_features != feature_dim:
        raise IncrementalUnavailable(
            "donor_incompatible",
            f"donor expects {donor.n_features} feature(s), data has {feature_dim}")
    Xs, ys = [], []
    for key in window_keys:
        train_idx, _test_idx = day_split_indices(len(parts[key]), dates[key], test_size,
                                                 split_seed)
        Xs.append(parts[key].X[train_idx])
        ys.append(parts[key].y[train_idx])
    ft_steps = max(MIN_FINE_TUNE_STEPS, int(cfg.n_steps * FINE_TUNE_STEPS_FRACTION))
    # seeded per (config seed, day): a rerun draws the same minibatches,
    # and each day fresh ones
    base_seed = cfg.seed if fit_seed is None else fit_seed
    tuned = donor.fine_tune(np.concatenate(Xs), np.concatenate(ys), n_steps=ft_steps,
                            seed=int(base_seed) + data_date.toordinal())
    metrics = tuned.evaluate(*_window_eval_arrays(parts, window_keys, dates, test_size,
                                                  split_seed))
    rows_touched = sum(len(parts[k]) for k in window_keys)
    fence(tuned.params)
    _record_train_metrics(tuned, metrics, perf_counter() - t0, rows_touched,
                          mode="incremental", rows_touched=rows_touched)
    log.info(f"incremental mlp fine-tune: {ft_steps} step(s) from donor {donor.info} on "
             f"a {len(window_keys)}-day replay ({rows_touched} rows) on {dev}: "
             f"MAPE={metrics['MAPE']:.4f} r2={metrics['r_squared']:.4f}")
    # the band from the replay window's labels, every row: under drift the
    # recent window is the range this candidate will serve
    bounds = _prediction_bounds(np.concatenate([parts[k].y for k in window_keys]))
    result = TrainResult(tuned, metrics, data_date, None, None, rows_touched,
                         prediction_bounds=bounds, mode="incremental",
                         rows_touched=rows_touched)
    if persist:
        from bodywork_tpu_torch.train.trainer import persist_train_result

        result = persist_train_result(store, result)
    return result


# -- dispatch --------------------------------------------------------------


def train_incremental(store: ArtefactStore, model_type: str = "linear",
                      model_kwargs: dict | None = None, test_size: float = 0.2,
                      split_seed: int = 42, fit_seed: int | None = None,
                      persist: bool = True, tail_days: int = TAIL_DAYS,
                      device=None) -> TrainResult:
    """Mode dispatcher with the degradation contract: a structural
    incapacity of the incremental path falls back to the full refit, its
    reason logged and recorded on the result."""
    try:
        if model_type == "linear":
            return incremental_train_linear(
                store, model_kwargs=model_kwargs, test_size=test_size,
                split_seed=split_seed, tail_days=tail_days, persist=persist, device=device)
        if model_type == "mlp":
            return incremental_train_mlp(
                store, model_kwargs=model_kwargs, test_size=test_size,
                split_seed=split_seed, fit_seed=fit_seed, tail_days=tail_days,
                persist=persist, device=device)
        raise IncrementalUnavailable("unsupported_model",
                                     f"no incremental path for {model_type!r}")
    except IncrementalUnavailable as exc:
        count_fallback(exc.reason)
        log.warning(f"incremental {model_type} train unavailable ({exc.reason}: {exc}); "
                    "falling back to a full refit")
        from bodywork_tpu_torch.train.trainer import train_on_history

        result = train_on_history(store, model_type, test_size=test_size,
                                  split_seed=split_seed, fit_seed=fit_seed,
                                  model_kwargs=model_kwargs, persist=persist, device=device)
        return dataclasses.replace(result, fallback_reason=exc.reason)
