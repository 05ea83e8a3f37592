"""Dependency-free metrics registry: counters, gauges, histograms (a copy
of ``bodywork_tpu.obs.registry``).

The port keeps its own copy so that it imports nothing of the JAX
package; the names, label sets, bucket bounds and the exposition text are
the JAX package's byte for byte, so a dashboard written for one service
reads the other unchanged (``tests/test_torch_obs.py`` holds the two
renderings equal).

- **Stdlib only.** The scoring hot path imports it.
- **Snapshot-centric.** A metric's state serialises to a plain dict
  (``Registry.snapshot``) and all rendering goes through snapshots
  (``render_snapshot``), so merged worker snapshots
  (:func:`merge_snapshots`) render through the same code as one process.
- **Name lint at registration.** Every metric name must match
  ``bodywork_tpu_[a-z0-9_]+`` and end in a recognised unit suffix
  (:data:`UNIT_SUFFIXES`); counters must end ``_total``.
- **Fixed-bucket histograms.** Cumulative bucket counts merge across
  processes by element-wise addition.

Thread safety: one lock per metric guards its label children; values are
plain floats mutated under that lock.
"""
from __future__ import annotations

import re
import threading

__all__ = [
    "METRIC_NAME_RE",
    "UNIT_SUFFIXES",
    "DEFAULT_LATENCY_BUCKETS",
    "validate_metric_name",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "get_registry",
    "merge_snapshots",
    "render_snapshot",
]

#: the framework's metric namespace: lowercase snake_case under one prefix
METRIC_NAME_RE = re.compile(r"^bodywork_tpu_[a-z0-9_]+$")

#: recognised unit suffixes (Prometheus naming conventions, plus the
#: domain units the framework measures). ``_total`` is reserved for
#: counters; ``_loss`` is the unitless training-loss channel; ``_state``
#: a small-integer state-machine gauge; ``_depth`` a queue-occupancy
#: gauge (the admission layer's saturation signal); ``_in_flight`` an
#: outstanding-work gauge counted in requests.
UNIT_SUFFIXES = (
    "_total",
    "_seconds",
    "_bytes",
    "_rows",
    "_requests",
    "_ratio",
    "_count",
    "_info",
    "_loss",
    "_state",
    "_depth",
    "_in_flight",
)

#: default histogram buckets, tuned for this service's latency regime:
#: sub-ms device dispatches up through multi-second stage times
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def validate_metric_name(name: str, metric_type: str) -> None:
    """The registration-time metric-name lint. Raises ``ValueError`` for
    names outside the ``bodywork_tpu_`` namespace, names without a
    recognised unit suffix, counters not ending ``_total``, and
    non-counters ending ``_total``."""
    if not METRIC_NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} must match {METRIC_NAME_RE.pattern}"
        )
    if not name.endswith(UNIT_SUFFIXES):
        raise ValueError(
            f"metric name {name!r} must end in a unit suffix "
            f"{UNIT_SUFFIXES}"
        )
    if metric_type == "counter" and not name.endswith("_total"):
        raise ValueError(f"counter {name!r} must end in '_total'")
    if metric_type != "counter" and name.endswith("_total"):
        raise ValueError(
            f"{metric_type} {name!r} must not end in '_total' "
            "(reserved for counters)"
        )


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Shared labelled-sample machinery. Subclasses define the per-label
    value struct and how to mutate it."""

    type = "untyped"

    def __init__(self, name: str, help: str = ""):
        validate_metric_name(name, self.type)
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._samples: dict[tuple, object] = {}

    def _sample(self, labels: dict):
        key = _label_key(labels)
        sample = self._samples.get(key)
        if sample is None:
            sample = self._samples[key] = self._new_sample()
        return sample

    def _peek(self, labels: dict):
        """Read-path lookup: NEVER inserts — probing a label set that was
        never observed must not add a phantom zero series to the
        exposition. Returns None when absent."""
        return self._samples.get(_label_key(labels))


class _ScalarMetric(_Metric):
    """Shared machinery for single-float-per-label-set metrics: the
    read path (peek-or-zero, never inserting) and snapshot shape live
    here ONCE so counter and gauge cannot diverge."""

    def _new_sample(self):
        return [0.0]

    def value(self, **labels) -> float:
        with self._lock:
            sample = self._peek(labels)
            return 0.0 if sample is None else sample[0]

    def snapshot_samples(self) -> list[dict]:
        with self._lock:
            return [
                {"labels": dict(k), "value": v[0]}
                for k, v in self._samples.items()
            ]


class Counter(_ScalarMetric):
    """Monotonic counter. Multiprocess merge: sum."""

    type = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._sample(labels)[0] += amount


class Gauge(_ScalarMetric):
    """Point-in-time value. ``aggregate`` declares the multiprocess merge
    semantics: "max" (default — e.g. a high-water mark), "min", "sum"
    (e.g. per-worker in-flight counts), or "mean"."""

    type = "gauge"

    def __init__(self, name: str, help: str = "", aggregate: str = "max"):
        if aggregate not in ("max", "min", "sum", "mean"):
            raise ValueError(f"unknown gauge aggregate {aggregate!r}")
        super().__init__(name, help)
        self.aggregate = aggregate

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._sample(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            self._sample(labels)[0] += amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative counts, Prometheus semantics).
    Multiprocess merge: element-wise bucket addition."""

    type = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
    ):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be ascending, got {buckets!r}")
        super().__init__(name, help)
        self.buckets = tuple(float(b) for b in buckets)

    def _new_sample(self):
        # per-bucket NON-cumulative counts + sum + count; rendered
        # cumulatively (the snapshot keeps them additive for merging).
        # "exemplars" holds the LAST exemplar (trace id + observed value)
        # per bucket, None where never set.
        return {
            "buckets": [0] * (len(self.buckets) + 1),  # +1: the +Inf bucket
            "sum": 0.0,
            "count": 0,
            "exemplars": [None] * (len(self.buckets) + 1),
        }

    def observe(self, value: float, exemplar: str | None = None, **labels) -> None:
        """Record one observation; ``exemplar`` (a trace id) is kept as
        the bucket's last exemplar. Exemplar-less observes leave the
        slot untouched — unsampled requests cost nothing extra here."""
        value = float(value)
        with self._lock:
            sample = self._sample(labels)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    break
            else:
                i = len(self.buckets)
            sample["buckets"][i] += 1
            if exemplar is not None:
                sample["exemplars"][i] = {
                    "trace_id": exemplar, "value": value,
                }
            sample["sum"] += value
            sample["count"] += 1

    def count(self, **labels) -> int:
        with self._lock:
            sample = self._peek(labels)
            return 0 if sample is None else sample["count"]

    def sum(self, **labels) -> float:
        with self._lock:
            sample = self._peek(labels)
            return 0.0 if sample is None else sample["sum"]

    def snapshot_samples(self) -> list[dict]:
        with self._lock:
            out = []
            for k, v in self._samples.items():
                entry = {
                    "labels": dict(k),
                    "buckets": list(v["buckets"]),
                    "sum": v["sum"],
                    "count": v["count"],
                }
                if any(e is not None for e in v["exemplars"]):
                    entry["exemplars"] = [
                        dict(e) if e is not None else None
                        for e in v["exemplars"]
                    ]
                out.append(entry)
            return out

    def exemplars(self, **labels) -> dict[str, str]:
        """``{bucket upper bound: trace id}`` for every bucket holding an
        exemplar — the /healthz view tying fat buckets to traces."""
        with self._lock:
            sample = self._peek(labels)
            if sample is None:
                return {}
            bounds = [_fmt_value(b) for b in self.buckets] + ["+Inf"]
            return {
                bounds[i]: e["trace_id"]
                for i, e in enumerate(sample["exemplars"])
                if e is not None
            }


class Registry:
    """Process-local metric registry. ``counter``/``gauge``/``histogram``
    are idempotent get-or-create (two call sites naming the same metric
    share it; a type or bucket conflict raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.type}, not {cls.type}"
                    )
                buckets = kwargs.get("buckets")
                if buckets is not None and tuple(buckets) != existing.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"different buckets"
                    )
                aggregate = kwargs.get("aggregate")
                if aggregate is not None and aggregate != existing.aggregate:
                    # two call sites declaring different multiprocess
                    # merge semantics is a bug, not a preference
                    raise ValueError(
                        f"gauge {name!r} already registered with "
                        f"aggregate={existing.aggregate!r}, not "
                        f"{aggregate!r}"
                    )
                return existing
            if kwargs.get("aggregate", "absent") is None:
                kwargs = {**kwargs, "aggregate": "max"}  # creation default
            metric = cls(name, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help=help)

    def gauge(
        self, name: str, help: str = "", aggregate: str | None = None
    ) -> Gauge:
        """``aggregate`` None means "no opinion": creation defaults to
        "max", and re-registration accepts whatever was declared. An
        EXPLICIT mode that conflicts with the existing one raises."""
        metric = self._get_or_create(
            Gauge, name, help=help, aggregate=aggregate
        )
        return metric

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help=help, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> dict:
        """JSON-able state of every metric — the single source both the
        in-process exposition and the multiprocess merge consume."""
        with self._lock:
            metrics = list(self._metrics.values())
        snap: dict = {}
        for m in metrics:
            entry: dict = {
                "type": m.type,
                "help": m.help,
                "samples": m.snapshot_samples(),
            }
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
            if isinstance(m, Gauge):
                entry["aggregate"] = m.aggregate
            snap[m.name] = entry
        return snap

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4) of this registry."""
        return render_snapshot(self.snapshot())

    def reset(self) -> None:
        """Drop every registered metric (tests and bench isolation)."""
        with self._lock:
            self._metrics.clear()


def _fmt_value(v) -> str:
    f = float(v)
    if f != f:  # NaN: the text format's literal, never a crash mid-scrape
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label_value(v) -> str:
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    # the text format requires \\ and \n escaping on HELP lines too — an
    # unescaped newline would turn the continuation into a malformed sample
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + body + "}"


def render_snapshot(snapshot: dict) -> str:
    """Render a (possibly merged) snapshot to Prometheus text format."""
    lines: list[str] = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        if entry["help"]:
            lines.append(f"# HELP {name} {_escape_help(entry['help'])}")
        lines.append(f"# TYPE {name} {entry['type']}")
        if entry["type"] == "histogram":
            bounds = entry["buckets"]
            for sample in entry["samples"]:
                cumulative = 0
                for bound, n in zip(bounds, sample["buckets"]):
                    cumulative += n
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(sample['labels'], {'le': _fmt_value(bound)})}"
                        f" {cumulative}"
                    )
                cumulative += sample["buckets"][-1]
                lines.append(
                    f"{name}_bucket"
                    f"{_fmt_labels(sample['labels'], {'le': '+Inf'})}"
                    f" {cumulative}"
                )
                lines.append(
                    f"{name}_sum{_fmt_labels(sample['labels'])}"
                    f" {_fmt_value(sample['sum'])}"
                )
                lines.append(
                    f"{name}_count{_fmt_labels(sample['labels'])}"
                    f" {sample['count']}"
                )
                # exemplar annotations (comment lines: the 0.0.4 text
                # format has no native exemplar syntax, so they ride as
                # parser-invisible comments): the last trace id observed
                # into each bucket
                exemplars = sample.get("exemplars")
                if exemplars:
                    le_bounds = [_fmt_value(b) for b in bounds] + ["+Inf"]
                    for i, exemplar in enumerate(exemplars):
                        if exemplar is None:
                            continue
                        lines.append(
                            f"# EXEMPLAR {name}_bucket"
                            f"{_fmt_labels(sample['labels'], {'le': le_bounds[i]})}"
                            f" trace_id={exemplar['trace_id']}"
                            f" value={_fmt_value(exemplar['value'])}"
                        )
        else:
            for sample in entry["samples"]:
                lines.append(
                    f"{name}{_fmt_labels(sample['labels'])}"
                    f" {_fmt_value(sample['value'])}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


def merge_snapshots(snapshots: list[dict]) -> dict:
    """Merge per-process snapshots into one coherent view: counters and
    histograms add; gauges combine per their declared ``aggregate``
    mode. Metrics appearing in only some snapshots merge from those."""
    merged: dict = {}
    # gauge "mean" needs the contributing-count; track per (name, labelkey)
    gauge_counts: dict[tuple, int] = {}
    for snap in snapshots:
        for name, entry in snap.items():
            target = merged.get(name)
            if target is None:
                target = merged[name] = {
                    "type": entry["type"],
                    "help": entry["help"],
                    "samples": [],
                    "_by_labels": {},
                }
                if "buckets" in entry:
                    target["buckets"] = list(entry["buckets"])
                if "aggregate" in entry:
                    target["aggregate"] = entry["aggregate"]
            elif target["type"] != entry["type"] or (
                "buckets" in entry
                and target.get("buckets") != list(entry["buckets"])
            ):
                # irreconcilable definitions (e.g. two code versions):
                # keep the first, skip the conflicting contribution
                continue
            for sample in entry["samples"]:
                key = _label_key(sample["labels"])
                existing = target["_by_labels"].get(key)
                if existing is None:
                    copy = dict(sample)
                    if "buckets" in copy:
                        copy["buckets"] = list(copy["buckets"])
                    target["_by_labels"][key] = copy
                    gauge_counts[(name, key)] = 1
                    continue
                if entry["type"] == "histogram":
                    existing["buckets"] = [
                        a + b
                        for a, b in zip(existing["buckets"], sample["buckets"])
                    ]
                    existing["sum"] += sample["sum"]
                    existing["count"] += sample["count"]
                    # exemplars: any contributor's exemplar beats none;
                    # between two, the later-merged snapshot wins (the
                    # semantics are "the LAST trace seen per bucket" and
                    # merge inputs carry no ordering evidence)
                    incoming = sample.get("exemplars")
                    if incoming:
                        current = existing.get("exemplars")
                        if current is None:
                            existing["exemplars"] = [
                                dict(e) if e is not None else None
                                for e in incoming
                            ]
                        else:
                            existing["exemplars"] = [
                                (dict(b) if b is not None else a)
                                for a, b in zip(current, incoming)
                            ]
                elif entry["type"] == "counter":
                    existing["value"] += sample["value"]
                else:  # gauge
                    # the TARGET's (first-seen) mode, not each entry's:
                    # two code versions declaring different modes must
                    # not make the merge order-dependent
                    mode = target.get("aggregate", "max")
                    if mode == "sum":
                        existing["value"] += sample["value"]
                    elif mode == "min":
                        existing["value"] = min(existing["value"], sample["value"])
                    elif mode == "mean":
                        n = gauge_counts[(name, key)]
                        existing["value"] = (
                            existing["value"] * n + sample["value"]
                        ) / (n + 1)
                        gauge_counts[(name, key)] = n + 1
                    else:  # max
                        existing["value"] = max(existing["value"], sample["value"])
    for entry in merged.values():
        entry["samples"] = list(entry.pop("_by_labels").values())
    return merged


#: the process-wide default registry every instrumented layer shares
_DEFAULT = Registry()


def get_registry() -> Registry:
    return _DEFAULT
