"""``engine="auto"`` asks the launch planner before it picks the f32
kernel: a model the kernel cannot launch (wider than its shared memory
holds, deeper than its layer cap, or in no cluster the card can
schedule) is served by the plain ``torch`` engine instead of failing the
serve. Held on the CPU with an H100's numbers passed in: 132 SMs and
232448 bytes of opt-in shared memory a block."""
import numpy as np
import pytest
import torch

from bodywork_tpu_torch.models import MLPConfig, MLPRegressor, params_from_jax
from bodywork_tpu_torch.ops import mlp_kernel as port
from bodywork_tpu_torch.serve import resolve_engine

torch.set_num_threads(1)

N_SMS = 132
BUDGET = 232_448
CUDA = torch.device("cuda")


def _h100_occupancy(cluster: int, smem_bytes: int) -> int:
    return N_SMS // cluster


def _model(hidden):
    rng = np.random.default_rng(0)
    sizes = (1, *hidden, 1)
    host = {
        "net": {"layers": [
            {"w": rng.normal(size=(i, o)).astype(np.float32) * np.sqrt(2 / i),
             "b": np.zeros(o, np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])
        ]},
        "scaler": {"x_mean": np.array([50.0], np.float32), "x_std": np.array([29.0], np.float32),
                   "y_mean": np.float32(26.0), "y_std": np.float32(15.0)},
    }
    return MLPRegressor(MLPConfig(hidden=hidden), params_from_jax(host, "cpu"))


@pytest.mark.parametrize("hidden,engine", [
    ((1280,) * 3, "kernel"),
    ((1024,) * 3, "kernel"),
    ((1344,) * 3, "torch"),       # past the f32 kernel's shared memory
    ((256,) * 16, "torch"),       # 17 layers: past the layer cap of 16
    ((256,) * 15, "kernel"),      # 16 layers
], ids=["1280x3", "1024x3", "1344x3", "17-layers", "16-layers"])
def test_auto_resolves_by_what_the_kernel_can_launch(hidden, engine):
    got = resolve_engine("auto", _model(hidden), CUDA, n_sms=N_SMS,
                         smem_budget=BUDGET, max_active=_h100_occupancy)
    assert got == engine


def test_auto_logs_the_reason(caplog):
    import logging

    caplog.set_level(logging.WARNING)
    resolve_engine("auto", _model((1344,) * 3), CUDA, n_sms=N_SMS,
                   smem_budget=BUDGET, max_active=_h100_occupancy)
    assert "cannot launch" in caplog.text and "shared memory" in caplog.text


def test_auto_refuses_a_stack_no_cluster_can_schedule():
    """Fits shared memory, but the occupancy query schedules no cluster."""
    got = resolve_engine("auto", _model((1024,) * 3), CUDA, n_sms=N_SMS,
                         smem_budget=BUDGET, max_active=lambda c, smem: 0)
    assert got == "torch"


def test_explicit_engines_pass_through():
    """An explicit kernel on a model it cannot launch still raises when
    its predictor is built (here: the plan itself refuses the stack)."""
    wide = _model((1344,) * 3)
    assert resolve_engine("kernel", wide, CUDA, n_sms=N_SMS, smem_budget=BUDGET) == "kernel"
    with pytest.raises(ValueError, match="shared"):
        port.launch_plans([1, 1344, 1344, 1344, 1], 1, "kernel", N_SMS, BUDGET)


@pytest.mark.parametrize("widths", [
    [1, 1344, 1344, 1344, 1], [1] + [256] * 16 + [1], [], [1, "x", 1], None,
])
def test_launch_refusal_never_raises(widths):
    reason = port.launch_refusal(widths, "kernel", N_SMS, BUDGET)
    assert isinstance(reason, str) and reason


@pytest.mark.parametrize("engine,widest_fit,first_refused", [
    ("kernel", 1280, 1344), ("kernel-bf16", 1536, 1600), ("kernel-int8", 1600, 1664),
])
def test_launch_refusal_edges_per_engine(engine, widest_fit, first_refused):
    for width, fits in ((widest_fit, True), (first_refused, False)):
        reason = port.launch_refusal([1, width, width, width, 1], engine, N_SMS, BUDGET,
                                     _h100_occupancy)
        assert (reason is None) == fits, (width, reason)


@pytest.mark.parametrize("query", ["negative", "raises"])
def test_launch_refusal_raises_on_a_failing_occupancy_query(query):
    """A failed occupancy query (-cudaError, or an error of its own) is a
    broken kernel, not a plan the card refuses: it raises rather than
    sending ``auto`` to the torch engine."""
    def failing(cluster, smem):
        if query == "raises":
            raise RuntimeError("no device context")
        return -1

    with pytest.raises(RuntimeError, match="cudaError 1|no device context"):
        port.launch_refusal([1, 64, 1], "kernel", N_SMS, BUDGET, failing)
    with pytest.raises(RuntimeError, match="cudaError 1|no device context"):
        resolve_engine("auto", _model((1024,) * 3), CUDA, n_sms=N_SMS,
                       smem_budget=BUDGET, max_active=failing)


def test_launch_refusal_answers_a_plan_refusal_before_the_query():
    """A stack that fits no plan is refused without asking the card."""
    def unreachable(cluster, smem):
        raise AssertionError("queried")

    reason = port.launch_refusal([1, 1344, 1344, 1344, 1], "kernel", N_SMS, BUDGET,
                                 unreachable)
    assert "shared memory" in reason


def test_occupancy_query_names_the_cuda_error(monkeypatch):
    """The built library's query answers -cudaError on a failure; the
    wrapper raises with the library's name for that error."""
    from bodywork_tpu_torch.ops import _build

    class Lib:
        @staticmethod
        def mlp_f32_max_active_clusters(cluster, smem):
            return -98 if smem > 1000 else 3

        @staticmethod
        def mlp_f32_error_string(code):
            return b"invalid device function" if code == 98 else b"?"

    monkeypatch.setattr(_build, "load_library", lambda name: Lib)
    max_active = port.occupancy_query("kernel")
    assert max_active(2, 100) == 3
    with pytest.raises(RuntimeError, match=r"invalid device function \(cudaError 98\)"):
        max_active(2, 2000)
