"""Admission control (``bodywork_tpu_torch.serve.admission``) against the
JAX package's: the same admit, shed and release sequences (seeded, with
an upstream depth probe and a drain) give the same decisions, the same
``Retry-After`` and the same ``state()``, count the same sheds by
reason, and ``build_admission`` arms the same controllers per engine."""
import threading

import numpy as np
import pytest
import torch

from bodywork_tpu.obs import get_registry as jax_registry
from bodywork_tpu.serve import admission as jax_admission
from bodywork_tpu_torch.obs import get_registry as port_registry
from bodywork_tpu_torch.serve import admission as port_admission

torch.set_num_threads(1)


def _sequence(seed: int, n: int = 200):
    """Seeded operations: ('admit',), ('release', delay or None),
    ('probe', depth), ('drain',) late in some runs."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        r = rng.random()
        if r < 0.5:
            ops.append(("admit",))
        elif r < 0.85:
            delay = None if rng.random() < 0.1 else float(rng.choice(
                [rng.exponential(0.5), rng.exponential(8.0), 45.0, 0.0]))
            ops.append(("release", delay))
        else:
            ops.append(("probe", int(rng.integers(0, 12))))
        if seed % 2 and i == int(0.8 * n):
            ops.append(("drain",))
    return ops


def _replay(module, ops, **kwargs):
    controller = module.AdmissionController(**kwargs)
    depth = [0]
    controller.attach_depth_probe(lambda: depth[0])
    trace = []
    for op in ops:
        if op[0] == "admit":
            trace.append(("admit", controller.try_admit()))
        elif op[0] == "release":
            controller.release(op[1])
        elif op[0] == "probe":
            depth[0] = op[1]
        else:
            controller.begin_drain()
        trace.append((controller.retry_after_s(), controller.queue_depth,
                      controller.state(), controller.max_observed_pending,
                      controller.draining))
    return trace


def _sheds(registry):
    return {reason: registry().counter(jax_admission.SHED_TOTAL_METRIC).value(reason=reason)
            for reason in ("admission", "drain")}


@pytest.mark.parametrize("seed,kwargs", [
    (0, {"max_pending": 8}),
    (1, {"max_pending": 8}),
    (2, {"max_pending": 3, "retry_after_max_s": 4.0}),
    (3, {"max_pending": 1, "ewma_alpha": 1.0}),
    (4, {"max_pending": 16, "retry_after_min_s": 2.0, "retry_after_max_s": 2.0}),
    (5, {}),
])
def test_the_same_sequence_gives_the_same_decisions_and_state(seed, kwargs):
    ops = _sequence(seed)
    port_before, jax_before = _sheds(port_registry), _sheds(jax_registry)
    port = _replay(port_admission, ops, **kwargs)
    ref = _replay(jax_admission, ops, **kwargs)
    assert port == ref
    decisions = [d for kind, d in (t for t in port if len(t) == 2)]
    assert True in decisions
    if kwargs.get("max_pending", 512) <= 8:
        assert False in decisions  # the budget was hit
    port_after, jax_after = _sheds(port_registry), _sheds(jax_registry)
    assert ({k: port_after[k] - port_before[k] for k in port_after}
            == {k: jax_after[k] - jax_before[k] for k in jax_after})


def test_retry_after_is_the_clamped_ceiled_ewma_like_jax():
    for module in (port_admission, jax_admission):
        c = module.AdmissionController(max_pending=4, retry_after_max_s=30.0)
        assert c.retry_after_s() == 1  # cold estimator: the minimum
        assert c.try_admit()
        c.release(2.2)
        assert c.retry_after_s() == 3  # ceil(2.2)
        c.try_admit()
        c.release(1000.0)  # ewma 0.2*1000 + 0.8*2.2 = 201.76 -> capped
        assert c.retry_after_s() == 30
        assert c.ewma_delay_s == pytest.approx(201.76)


@pytest.mark.parametrize("kwargs", [{"max_pending": 0}, {"ewma_alpha": 0.0},
                                    {"ewma_alpha": 1.5}, {"retry_after_min_s": 0.0},
                                    {"retry_after_min_s": 5.0, "retry_after_max_s": 2.0}])
def test_the_same_arguments_are_refused(kwargs):
    messages = []
    for module in (port_admission, jax_admission):
        with pytest.raises(ValueError) as exc:
            module.AdmissionController(**kwargs)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_begin_drain_sheds_new_work_while_in_flight_work_releases():
    for module, registry in ((port_admission, port_registry),
                             (jax_admission, jax_registry)):
        shed = registry().counter(module.SHED_TOTAL_METRIC)
        before = shed.value(reason="drain")
        c = module.AdmissionController(max_pending=4)
        assert c.try_admit() and c.try_admit()
        c.begin_drain()
        assert c.draining
        assert not c.try_admit() and not c.try_admit()
        assert shed.value(reason="drain") == before + 2
        c.release(0.1)
        c.release(0.1)
        state = c.state()
        assert state["pending"] == 0 and state["shed_total"] == 2
        assert state["admitted_total"] == 2


def test_the_depth_gauge_and_a_broken_probe():
    from bodywork_tpu_torch.obs import get_registry

    c = port_admission.AdmissionController(max_pending=2)
    gauge = get_registry().get(port_admission.QUEUE_DEPTH_METRIC)
    assert gauge.aggregate == "sum"
    c.try_admit()
    assert gauge.value() == 1.0
    c.attach_depth_probe(lambda: 1 / 0)  # a broken probe never breaks admission
    assert c.try_admit() and c.queue_depth == 2
    assert not c.try_admit()
    c.release()
    c.release()
    assert gauge.value() == 0.0 and c.queue_depth == 0


def test_the_budget_holds_under_concurrent_admission():
    c = port_admission.AdmissionController(max_pending=5)
    held, lock = [0], threading.Lock()
    errors = []
    start = threading.Barrier(16)

    def worker():
        start.wait()
        for _ in range(200):
            if c.try_admit():
                with lock:
                    held[0] += 1
                    if held[0] > 5:
                        errors.append(held[0])
                with lock:
                    held[0] -= 1
                c.release(0.0)

    threads = [threading.Thread(target=worker) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and c.max_observed_pending <= 5
    assert c.state()["pending"] == 0


@pytest.mark.parametrize("engine", ["thread", "aio"])
@pytest.mark.parametrize("max_pending", [None, 8])
@pytest.mark.parametrize("retry_after_max_s", [None, 3.0])
def test_build_admission_arms_per_engine_like_jax(engine, max_pending, retry_after_max_s):
    port = port_admission.build_admission(engine, max_pending, retry_after_max_s)
    ref = jax_admission.build_admission(engine, max_pending, retry_after_max_s)
    assert (port is None) == (ref is None)
    if engine == "aio" or max_pending is not None:
        assert port is not None
        assert port.max_pending == ref.max_pending == (max_pending or 512)
        assert port.retry_after_max_s == ref.retry_after_max_s
        assert port.state() == ref.state()


def test_the_constants_are_jaxs():
    for name in ("DEFAULT_MAX_PENDING", "SHED_TOTAL_METRIC", "QUEUE_DEPTH_METRIC"):
        assert getattr(port_admission, name) == getattr(jax_admission, name)
    from bodywork_tpu.serve.server import SERVER_ENGINES as JAX_SERVER_ENGINES
    from bodywork_tpu_torch.serve.server import SERVER_ENGINES, build_admission

    assert SERVER_ENGINES == JAX_SERVER_ENGINES
    assert build_admission is port_admission.build_admission
