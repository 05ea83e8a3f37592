"""The port's metrics registry (``bodywork_tpu_torch.obs``) against the JAX
package's (``bodywork_tpu.obs``): the same sequence of operations renders
the same Prometheus text byte for byte, snapshots and merges equal, the
name lint refuses the same names, and every metric name the port
registers is one the JAX package registers."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bodywork_tpu.obs import registry as jax_obs
from bodywork_tpu_torch.obs import registry as port_obs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _script(seed: int):
    """A seeded sequence of registry operations: (kind, name, kwargs,
    [(method, args, labels)...]) per metric, with labels, repeats, exotic
    values (NaN, inf, 0, negatives for gauges), help texts that need
    escaping, and exemplars."""
    rng = np.random.default_rng(seed)
    routes = ["/score/v1", "/score/v1/batch", 'we"ird\\path', "line\nbreak"]
    ops = []
    ops.append(("counter", "bodywork_tpu_http_requests_total",
                {"help": "HTTP requests served, by route and status"},
                [("inc", (float(rng.integers(1, 4)),),
                  {"route": routes[rng.integers(len(routes))],
                   "status": str(rng.choice([200, 400, 429]))}) for _ in range(12)]))
    ops.append(("gauge", "bodywork_tpu_serve_queue_depth",
                {"help": "depth\nwith newline \\ and backslash", "aggregate": "sum"},
                [("set", (float(v),), {}) for v in rng.integers(0, 9, 3)]
                + [("inc", (2.5,), {"worker": "1"}), ("dec", (1.0,), {"worker": "1"})]))
    ops.append(("gauge", "bodywork_tpu_train_mape_ratio", {"help": ""},
                [("set", (float("nan"),), {}), ("set", (float("inf"),), {"k": "a"}),
                 ("set", (-0.0,), {"k": "b"}), ("set", (1e20,), {"k": "c"}),
                 ("set", (0.1 + 0.2,), {"k": "d"})]))
    buckets = tuple(sorted(set(np.round(rng.uniform(0.001, 2.0, 5), 4).tolist())))
    obs = []
    for i in range(20):
        v = float(rng.choice([rng.uniform(0, 3), 0.0, math.inf, buckets[0]]))
        exemplar = f"{i:032x}" if rng.random() < 0.4 else None
        obs.append(("observe", (v,), {"exemplar": exemplar,
                                      "phase": str(rng.choice(["parse", "dispatch"]))}))
    ops.append(("histogram", "bodywork_tpu_device_dispatch_seconds",
                {"help": "Device-dispatch phase", "buckets": buckets}, obs))
    ops.append(("histogram", "bodywork_tpu_scoring_latency_seconds",
                {"help": "End-to-end handler time"},
                [("observe", (float(v),), {}) for v in rng.exponential(0.01, 30)]))
    return ops


def _run(module, ops):
    reg = module.Registry()
    for kind, name, kwargs, calls in ops:
        metric = getattr(reg, kind)(name, **kwargs)
        for method, args, labels in calls:
            labels = dict(labels)
            if method == "observe":
                exemplar = labels.pop("exemplar", None)
                metric.observe(*args, exemplar=exemplar, **labels)
            else:
                getattr(metric, method)(*args, **labels)
    return reg


@pytest.mark.parametrize("seed", range(6))
def test_the_same_operations_render_byte_equal_to_jax(seed):
    ops = _script(seed)
    port, ref = _run(port_obs, ops), _run(jax_obs, ops)
    assert port.render() == ref.render()
    assert port.snapshot() == ref.snapshot()
    # the read accessors agree (and neither inserts a phantom series)
    for kind, name, _kwargs, _calls in ops:
        p, r = port.get(name), ref.get(name)
        if kind == "histogram":
            assert p.count() == r.count() and p.sum() == r.sum()
            assert p.exemplars(phase="parse") == r.exemplars(phase="parse")
            assert p.count(phase="never") == r.count(phase="never") == 0
        else:
            assert p.value(k="never") == r.value(k="never") == 0
    assert port.render() == ref.render()


@pytest.mark.parametrize("seeds", [(0, 1), (2, 3, 4), (5, 5)])
def test_merge_snapshots_equal_to_jax(seeds):
    snaps = [_run(port_obs, _script(s)).snapshot() for s in seeds]
    merged = port_obs.merge_snapshots(snaps)
    assert merged == jax_obs.merge_snapshots(snaps)
    assert port_obs.render_snapshot(merged) == jax_obs.render_snapshot(merged)


def test_merge_combines_gauges_by_their_aggregate_like_jax():
    def snap(module, v):
        reg = module.Registry()
        for mode in ("max", "min", "sum", "mean"):
            reg.gauge(f"bodywork_tpu_{mode}_rows", aggregate=mode).set(v)
        reg.histogram("bodywork_tpu_h_seconds", buckets=(1.0,)).observe(v)
        return reg.snapshot()

    for module in (port_obs, jax_obs):
        snaps = [snap(module, v) for v in (1.0, 4.0, 2.5)]
        assert port_obs.merge_snapshots(snaps) == jax_obs.merge_snapshots(snaps)
    # a conflicting bucket definition keeps the first, in both
    a, b = port_obs.Registry(), port_obs.Registry()
    a.histogram("bodywork_tpu_h_seconds", buckets=(1.0,)).observe(0.5)
    b.histogram("bodywork_tpu_h_seconds", buckets=(2.0,)).observe(0.5)
    pair = [a.snapshot(), b.snapshot()]
    assert port_obs.merge_snapshots(pair) == jax_obs.merge_snapshots(pair)


@pytest.mark.parametrize("name,kind", [
    ("bodywork_tpu_http_requests_total", "counter"),
    ("bodywork_tpu_queue_wait_seconds", "histogram"),
    ("bodywork_tpu_train_rows", "gauge"),
    ("bodywork_tpu_serve_queue_depth", "gauge"),
    ("bodywork_tpu_rowqueue_in_flight", "gauge"),
    ("widget_total", "counter"),
    ("bodywork_tpu_Widget_total", "counter"),
    ("bodywork_tpu_latency", "histogram"),
    ("bodywork_tpu_requests_total", "gauge"),
    ("bodywork_tpu_requests", "counter"),
    ("bodywork_tpu_x-y_total", "counter"),
    ("bodywork_tpu__total", "counter"),
])
def test_name_lint_refuses_the_same_names(name, kind):
    def verdict(module):
        try:
            module.validate_metric_name(name, kind)
        except ValueError as exc:
            return str(exc)
        return None

    assert verdict(port_obs) == verdict(jax_obs)


@pytest.mark.parametrize("case", ["type", "buckets", "aggregate", "negative", "bounds"])
def test_registration_errors_match_jax(case):
    def attempt(module):
        reg = module.Registry()
        try:
            if case == "type":
                reg.counter("bodywork_tpu_x_total")
                reg.gauge("bodywork_tpu_x_total")
            elif case == "buckets":
                reg.histogram("bodywork_tpu_x_seconds", buckets=(1.0,))
                reg.histogram("bodywork_tpu_x_seconds", buckets=(2.0,))
            elif case == "aggregate":
                reg.gauge("bodywork_tpu_x_rows", aggregate="sum")
                assert reg.gauge("bodywork_tpu_x_rows").aggregate == "sum"
                reg.gauge("bodywork_tpu_x_rows", aggregate="max")
            elif case == "negative":
                reg.counter("bodywork_tpu_x_total").inc(-1)
            else:
                reg.histogram("bodywork_tpu_x_seconds", buckets=(1.0, 0.5))
        except ValueError as exc:
            return str(exc)
        return None

    assert attempt(port_obs) == attempt(jax_obs) is not None


def test_the_constants_are_jaxs():
    assert port_obs.METRIC_NAME_RE.pattern == jax_obs.METRIC_NAME_RE.pattern
    assert port_obs.UNIT_SUFFIXES == jax_obs.UNIT_SUFFIXES
    assert port_obs.DEFAULT_LATENCY_BUCKETS == jax_obs.DEFAULT_LATENCY_BUCKETS


def _metric_names(package: str) -> set:
    names = set()
    for path in (ROOT / package).rglob("*.py"):
        for name in re.findall(r'"(bodywork_tpu_[a-z0-9_]+)"', path.read_text()):
            if name.endswith(jax_obs.UNIT_SUFFIXES):
                names.add(name)
    return names


def test_every_port_metric_name_is_a_jax_metric_name():
    """A dashboard written for the JAX service reads the port's: every
    metric the port registers exists, under that name, in the JAX
    package."""
    port = _metric_names("bodywork_tpu_torch")
    assert port, "the port registers no metric"
    assert port <= _metric_names("bodywork_tpu"), port - _metric_names("bodywork_tpu")


def test_the_process_registry_is_one_object():
    from bodywork_tpu_torch.obs import get_registry

    assert get_registry() is get_registry()
    assert isinstance(get_registry(), port_obs.Registry)
