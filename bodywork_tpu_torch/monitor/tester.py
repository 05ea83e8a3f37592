"""Live-service tester (the port of ``bodywork_tpu.monitor.tester``), on
the standard library and numpy: no requests, no pandas.

Black-box tests the deployed scoring service over HTTP with the latest
day's labeled data, computes the drift metrics and persists them under
``test-metrics/``. Metric definitions are the JAX package's
(``tester.py:306-348``): MAPE = mean APE (label-guarded denominator),
``r_squared`` = Pearson correlation of score vs label, ``max_residual`` =
max APE, ``mean_response_time`` of the HTTP round-trip, ``n_failures``
counted apart and excluded, plus the bias channel ``mean_error``,
``error_std`` (sample std, ddof=1) and ``n_scored``.

The HTTP client retries 5xx/429 responses and connection failures
through the shared policy (:mod:`bodywork_tpu_torch.utils.retry`), with a
numeric ``Retry-After`` as a floor under the backoff — the JAX client's
budget. :class:`InProcessScoringClient` sends the same requests straight
to a scoring app object, with the same status retries: the day loop's
test stage without sockets.

Metrics, the JAX package's: ``bodywork_tpu_scoring_client_retries_total
{reason}`` (``status`` or ``connection``) for each retry of either
client, and after each test the ``bodywork_tpu_live_*`` family (runs,
rows scored, failed rows, and the latest MAPE, score/label correlation
and mean round-trip, the gauges left unset on a day with nothing
scored).
"""
from __future__ import annotations

import json
import math
import urllib.error
import urllib.request
from datetime import date
from time import perf_counter

import numpy as np

from bodywork_tpu_torch.data.io import Dataset, csv_record, load_latest_dataset
from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.schema import test_metrics_key
from bodywork_tpu_torch.utils.logging import get_logger
from bodywork_tpu_torch.utils.retry import RetryPolicy, call_with_retry, is_transient

log = get_logger("monitor.tester")

_APE_EPS = 2.220446049250313e-16

#: response statuses worth retrying: rate limiting and transient server
#: failures (a 4xx other than 429 is a deterministic client error)
RETRYABLE_STATUSES = frozenset({429, 500, 502, 503, 504})

#: rows per ``/score/v1/batch`` request in batch mode, unless the caller
#: says otherwise (the default pipeline's test stage sends 2048)
DEFAULT_BATCH_SIZE = 512

#: the client's budget: the JAX client's defaults (3 retries, 50 ms base
#: backoff capped at 1 s, a 30 s deadline, 10 s per request)
RETRY_POLICY = RetryPolicy(attempts=4, base_delay_s=0.05, max_delay_s=1.0, deadline_s=30.0)
TIMEOUT_S = 10.0

#: the metrics record's columns, in the JAX package's order
METRIC_COLUMNS = (
    "date", "MAPE", "r_squared", "max_residual", "mean_response_time",
    "n_failures", "mean_error", "error_std", "n_scored",
)


class _RetryableStatus(Exception):
    def __init__(self, status_code: int, retry_after_s: float | None):
        super().__init__(f"retryable scoring response: HTTP {status_code}")
        self.status_code = status_code
        self.retry_after_s = retry_after_s


def _retry_after_seconds(headers) -> float | None:
    raw = headers.get("Retry-After")
    if raw is None:
        return None
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return None


def _record_client_retry(exc, attempt, sleep_s) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_scoring_client_retries_total",
        "Scoring-client request retries by reason",
    ).inc(reason="status" if isinstance(exc, _RetryableStatus) else "connection")


def scoring_endpoint(base_url: str, mode: str = "single") -> str:
    """Normalise a scoring-service URL (a bare base, or one already
    carrying ``/score/v1[/batch]``) to the endpoint for ``mode``."""
    url = base_url.rstrip("/")
    for suffix in ("/score/v1/batch", "/score/v1"):
        if url.endswith(suffix):
            url = url[: -len(suffix)]
            break
    return url + ("/score/v1/batch" if mode == "batch" else "/score/v1")


class HttpScoringClient:
    """Scores over real HTTP (``urllib.request``) with per-request retries
    covering connection failures and retryable response statuses: full
    jitter backoff floored by a numeric ``Retry-After``, bounded by
    attempts and a deadline budget."""

    def __init__(self, url: str):
        self.url = url

    def _post(self, payload: dict):
        request = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(request, timeout=TIMEOUT_S) as resp:
                status, headers, body = resp.status, resp.headers, resp.read()
        except urllib.error.HTTPError as exc:  # a non-2xx response
            status, headers, body = exc.code, exc.headers, exc.read()
        if status in RETRYABLE_STATUSES:
            raise _RetryableStatus(status, _retry_after_seconds(headers))
        return status, body

    def score(self, payload: dict) -> tuple[bool, list[float], float]:
        """POST a payload; returns (ok, predictions, seconds). The elapsed
        time covers retries."""
        start = perf_counter()
        try:
            status, body = call_with_retry(
                lambda: self._post(payload), RETRY_POLICY,
                is_retryable=lambda e: isinstance(e, _RetryableStatus) or is_transient(e),
                on_retry=_record_client_retry,
            )
        except _RetryableStatus as exc:
            log.error(f"scoring request failed after retries: HTTP {exc.status_code}")
            return False, [], perf_counter() - start
        except OSError as exc:  # URLError, timeouts, refused connections
            log.error(f"scoring request failed: {exc!r}")
            return False, [], perf_counter() - start
        elapsed = perf_counter() - start
        if 200 <= status < 300:
            doc = json.loads(body)
            preds = doc["predictions"] if "predictions" in doc else [doc["prediction"]]
            return True, [float(p) for p in preds], elapsed
        log.error(f"scoring request failed: HTTP {status}")
        return False, [], elapsed


class InProcessScoringClient:
    """Scores through a scoring app's ``handle`` (a :class:`ScoringApp`
    or a replica front) without sockets, with the HTTP client's status
    retries on a tighter backoff: there is no network to be polite to."""

    POLICY = RetryPolicy(attempts=4, base_delay_s=0.005, max_delay_s=0.05, deadline_s=5.0)

    def __init__(self, app, path: str = "/score/v1"):
        self.app = app
        self.path = path

    def batch_sibling(self) -> "InProcessScoringClient":
        return InProcessScoringClient(self.app, "/score/v1/batch")

    def _post(self, payload: dict):
        status, headers, body = self.app.handle(
            "POST", self.path, json.dumps(payload).encode(), "application/json",
        )
        if status in RETRYABLE_STATUSES:
            raise _RetryableStatus(status, _retry_after_seconds(headers))
        return status, body

    def score(self, payload: dict) -> tuple[bool, list[float], float]:
        start = perf_counter()
        try:
            status, body = call_with_retry(
                lambda: self._post(payload), self.POLICY,
                is_retryable=lambda e: isinstance(e, _RetryableStatus),
                on_retry=_record_client_retry,
            )
        except _RetryableStatus as exc:
            log.error(f"scoring request failed after retries: HTTP {exc.status_code}")
            return False, [], perf_counter() - start
        elapsed = perf_counter() - start
        if status == 200:
            doc = json.loads(body)
            preds = doc["predictions"] if "predictions" in doc else [doc["prediction"]]
            return True, [float(p) for p in preds], elapsed
        log.error(f"scoring request failed: HTTP {status}")
        return False, [], elapsed


def _ape(score: float, label: float) -> float:
    return abs(score - label) / max(abs(label), _APE_EPS)


def score_dataset(client, ds: Dataset, mode: str = "single",
                  batch_size: int = DEFAULT_BATCH_SIZE) -> dict[str, np.ndarray]:
    """Score every labeled row via the live service, one row per request
    (``single``) or ``batch_size`` rows per request (``batch``). Returns
    the results as columns ``score, label, APE, response_time, ok`` (the
    reference's ``stage_4:98`` plus ``ok``)."""
    rows = []
    multi = ds.X.shape[1] > 1

    def _payload_row(i: int):
        # scalar for 1-feature parity with the reference payloads
        if multi:
            return [float(v) for v in ds.X[i]]
        return float(ds.X[i, 0])

    if mode == "single":
        for i, label in enumerate(ds.y):
            ok, preds, elapsed = client.score({"X": _payload_row(i)})
            score = preds[0] if ok else np.nan
            ape = _ape(score, float(label)) if ok else np.nan
            rows.append((score, float(label), ape, elapsed, ok))
    elif mode == "batch":
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        for i in range(0, len(ds.y), batch_size):
            yb = ds.y[i : i + batch_size]
            xb = ds.X[i : i + batch_size]
            if multi:
                payload = [[float(v) for v in row] for row in xb]
            else:
                payload = [float(v) for v in xb[:, 0]]
            ok, preds, elapsed = client.score({"X": payload})
            per_row_time = elapsed / max(len(xb), 1)
            if ok and len(preds) == len(xb):
                for p, label in zip(preds, yb):
                    rows.append((p, float(label), _ape(p, float(label)), per_row_time, True))
            else:
                rows.extend(
                    (np.nan, float(label), np.nan, per_row_time, False) for label in yb
                )
    else:
        raise ValueError(f"unknown scoring mode: {mode!r}")
    cols = list(zip(*rows)) if rows else [(), (), (), (), ()]
    return {
        "score": np.asarray(cols[0], dtype=np.float64),
        "label": np.asarray(cols[1], dtype=np.float64),
        "APE": np.asarray(cols[2], dtype=np.float64),
        "response_time": np.asarray(cols[3], dtype=np.float64),
        "ok": np.asarray(cols[4], dtype=bool),
    }


def compute_test_metrics(results: dict, results_date: date) -> dict:
    """One metrics record, keys in :data:`METRIC_COLUMNS` order."""
    ok = results["ok"]
    n_ok = int(ok.sum())
    nan = float("nan")
    mape = r_squared = max_residual = mean_error = error_std = nan
    if n_ok:
        score, label, ape = results["score"][ok], results["label"][ok], results["APE"][ok]
        mape = float(ape.mean())
        max_residual = float(ape.max())
        if n_ok > 1 and score.std() > 0 and label.std() > 0:
            r_squared = float(np.corrcoef(score, label)[0, 1])
        err = score - label
        mean_error = float(err.mean())
        error_std = float(err.std(ddof=1)) if n_ok > 1 else nan
    times = results["response_time"]
    return {
        "date": results_date,
        "MAPE": mape,
        "r_squared": r_squared,
        "max_residual": max_residual,
        "mean_response_time": float(times.mean()) if len(times) else nan,
        "n_failures": int((~ok).sum()),
        "mean_error": mean_error,
        "error_std": error_std,
        "n_scored": n_ok,
    }


def persist_test_metrics(store: ArtefactStore, metrics: dict, results_date: date) -> str:
    """Write ``test-metrics/regressor-test-results-<date>.csv``
    (``stage_4:116-134``), the JAX package's columns and order."""
    key = test_metrics_key(results_date)
    store.put_text(key, csv_record(METRIC_COLUMNS, metrics))
    log.info(f"persisted test metrics to {key}")
    return key


def _record_live_metrics(metrics: dict) -> None:
    """Export a day's live-test record through the shared obs registry:
    the numbers persisted to the date-keyed CSV as scrapeable counters and
    gauges."""
    from bodywork_tpu_torch.obs import get_registry

    reg = get_registry()
    reg.counter(
        "bodywork_tpu_live_test_runs_total", "Completed live-service tests"
    ).inc()
    reg.counter(
        "bodywork_tpu_live_test_rows_total",
        "Rows successfully scored by live-service tests",
    ).inc(float(metrics["n_scored"]))
    reg.counter(
        "bodywork_tpu_live_test_failures_total",
        "Rows whose live scoring request failed",
    ).inc(float(metrics["n_failures"]))
    gauges = (
        ("bodywork_tpu_live_mape_ratio",
         "Live MAPE of the latest service test", metrics["MAPE"]),
        ("bodywork_tpu_live_score_label_corr_ratio",
         "Live score/label correlation of the latest service test",
         metrics["r_squared"]),
        ("bodywork_tpu_live_response_mean_seconds",
         "Mean scoring-request round-trip of the latest service test",
         metrics["mean_response_time"]),
    )
    for name, help_, value in gauges:
        if not math.isnan(value):  # an all-failures day has no quality signal
            reg.gauge(name, help_).set(float(value))


def run_service_test(store: ArtefactStore, client, mode: str = "single",
                     max_rows: int | None = None,
                     batch_size: int = DEFAULT_BATCH_SIZE) -> dict:
    """Full test-stage flow: latest dataset -> score via the live service
    -> metrics -> persist. ``max_rows`` caps the scored rows (head of the
    day) for cheap smoke tests; ``batch_size`` is the rows per request in
    batch mode. Returns the metrics record."""
    ds = load_latest_dataset(store)
    if max_rows is not None and len(ds) > max_rows:
        ds = Dataset(ds.X[:max_rows], ds.y[:max_rows], ds.date)
    if mode == "batch" and isinstance(client, InProcessScoringClient):
        client = client.batch_sibling()
    results = score_dataset(client, ds, mode=mode, batch_size=batch_size)
    metrics = compute_test_metrics(results, ds.date)
    persist_test_metrics(store, metrics, ds.date)
    _record_live_metrics(metrics)
    log.info(
        f"live test on {len(results['ok'])} rows ({ds.date}): "
        f"MAPE={metrics['MAPE']:.4f} corr={metrics['r_squared']:.4f} "
        f"maxAPE={metrics['max_residual']:.2f} "
        f"mean_rt={metrics['mean_response_time'] * 1000:.2f}ms "
        f"failures={metrics['n_failures']}"
    )
    return metrics
