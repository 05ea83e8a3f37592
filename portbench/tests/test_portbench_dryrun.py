"""Whole runs of each cell on the CPU at a small size (``dryrun.py``, the
harness's look for a card skipped): the result line's shape, ``correct``,
and no module of JAX or the JAX package in the run's process; then the
same runs with the timed path broken, which must come out not
correct."""
import json
import subprocess
import sys

import pytest

from portbench.harness import FORBIDDEN_MODULES, loaded_forbidden, spec

BENCH = spec.with_parked(spec.load_benchmark())
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVE = [c for c in CELLS if c.startswith("serve-")]
TRAIN = [c for c in CELLS if c.startswith("train-")]


def dry_run(cell: str, trace: int, fault: str | None = None) -> tuple[int, dict | None, str]:
    cmd = [sys.executable, str(spec.HOME / "tests" / "dryrun.py"), cell, str(trace)]
    if fault:
        cmd.append(fault)
    out = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return out.returncode, result, out.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_dry_run_is_correct_and_prints_its_metrics(cell, trace):
    code, result, err = dry_run(cell, trace)
    assert code == 0, err[-3000:]
    assert result["correct"] is True, err[-3000:]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec.cell_metrics(BENCH, cell, kind)}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
        assert all(m["value"] > 0 for m in result["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
    # the checks are the last lines of standard error too
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split(":")[0] for line in tail] == [f"check {k}" for k in result["checks"]]


@pytest.mark.parametrize("cell, fault", [(c, f) for c in TRAIN
                                         for f in ("unchanged", "half_batch", "late_count")]
                         + [(c, "answer") for c in SERVE])
def test_a_broken_timed_path_comes_out_not_correct(cell, fault):
    code, result, err = dry_run(cell, 0, fault)
    assert code == 0, err[-3000:]
    assert result["correct"] is False


def test_the_forbidden_names_are_compared_whole():
    assert loaded_forbidden(["bodywork_tpu_torch.models", "numpy"]) == []
    assert loaded_forbidden(["bodywork_tpu.models", "jax.numpy", "jaxlib"]) == [
        "bodywork_tpu", "jax", "jaxlib"]
    assert set(FORBIDDEN_MODULES) == {"jax", "jaxlib", "flax", "bodywork_tpu"}


def test_a_run_with_a_forbidden_module_loaded_prints_no_result():
    code = ("import sys, types; sys.path.insert(0, '.'); sys.modules['jax'] = "
            "types.ModuleType('jax'); from portbench.harness import report, Context, Outcome, "
            "spec; b = spec.load_benchmark(); c = spec.cell(b, %r); "
            "print(report(b, Context(c, {}, {}, 0, 1.0, False, 0.0), Outcome({}, {}, 0, 0, "
            "{}, {}))[0])" % CELLS[0])
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "4" and "forbidden" in out.stderr


def test_without_the_port_a_run_fails_before_any_result(tmp_path):
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HOME, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
