"""The port's A/B pipelines (``bodywork_tpu_torch.pipeline.ab``) against the
JAX package's: variant names, each variant's artefacts byte-equal to a solo
run of it, failure containment, the device grouping, ``compare_report``'s
rows equal to the JAX DataFrame's records over the same stores, and ``cli
run-ab``."""
import math
from datetime import date

import pytest
import torch

from bodywork_tpu.pipeline import VariantResult as JaxVariantResult
from bodywork_tpu.pipeline import compare_report as jax_compare_report
from bodywork_tpu.pipeline import variants_from_model_types as jax_variants
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.pipeline import (
    compare_report,
    format_compare_report,
    run_ab_simulation,
    variants_from_model_types,
)
from bodywork_tpu_torch.pipeline.ab import _device_groups
from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE

torch.set_num_threads(1)

START = date(2026, 7, 1)
CPU = torch.device("cpu")
#: a small MLP the gate promotes on the small days below
SMALL_MLP = {"hidden": (32, 32), "n_steps": 400}


def _variants(models=("linear", "mlp")):
    variants = variants_from_model_types(list(models))
    for v in variants:
        v.drift = DriftConfig(n_samples=200)
        if v.name.endswith("mlp"):
            v.spec.stages[TRAIN_STAGE].args.update(SMALL_MLP)
    return variants


def _results_of(store) -> dict:
    """A store's results by key, as ``chip_smoke.py`` compares them: the
    journals and snapshots (operational state) left out, the test
    metrics without their wall-clock response time."""
    out = {}
    for key in store.list_keys():
        if key.startswith(("runs/", "snapshots/")):
            continue
        data = store.get_bytes(key)
        if key.startswith("test-metrics/"):
            lines = data.decode().splitlines()
            i = lines[0].split(",").index("mean_response_time")
            data = "\n".join(",".join(f for j, f in enumerate(line.split(",")) if j != i)
                             for line in lines).encode()
        out[key] = data
    return out


def test_variant_names_equal_jaxs():
    for models in (["linear", "mlp"], ["mlp", "linear", "mlp"]):
        assert [v.name for v in variants_from_model_types(models)] == [
            v.name for v in jax_variants(models)]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("ab")
    results = run_ab_simulation(_variants(), root / "pair", START, 2, devices=[CPU])
    return root, results


def test_each_variant_of_a_concurrent_pair_equals_its_solo_run(pair):
    root, results = pair
    assert {k: v.error for k, v in results.items()} == {"a-linear": None, "b-mlp": None}
    for name, variant in zip(("a-linear", "b-mlp"), _variants()):
        solo = run_ab_simulation([variant], root / f"solo-{name}", START, 2, devices=[CPU])
        assert solo[name].error is None and len(solo[name].results) == 2
        got, want = _results_of(results[name].store), _results_of(solo[name].store)
        assert sorted(got) == sorted(want)
        assert {k for k in got if got[k] != want[k]} == set()
        assert any(k.startswith("registry/") for k in got)


def test_compare_report_rows_equal_jaxs_records(pair):
    _root, results = pair
    rows = compare_report(results)
    jax_results = {name: JaxVariantResult(name, [], JaxStore(vr.store.root))
                   for name, vr in results.items()}
    records = jax_compare_report(jax_results).to_dict("records")
    assert len(rows) == len(records) == 6
    for row, record in zip(rows, records):
        assert list(row) == list(record)
        for key, value in record.items():
            got = row[key]
            if isinstance(value, float) and math.isnan(value):
                assert got is None
            elif isinstance(value, float):
                # pandas' default CSV float parser may land an ulp off the
                # decimal text; the port's float() reads it exactly
                assert math.isclose(got, value, rel_tol=2 * 2**-52), key
            else:
                assert got == value, key
    table = format_compare_report(rows).splitlines()
    assert len(table) == 7 and table[0].split() == list(rows[0])


def test_a_failed_variant_is_contained(tmp_path):
    variants = _variants(("linear", "linear"))
    variants[1].name = "b-linear"
    variants[1].spec.stages[TRAIN_STAGE].executable = "no.such:fn"
    variants[1].spec.stages[TRAIN_STAGE].retries = 0
    results = run_ab_simulation(variants, tmp_path, START, 1, devices=[CPU])
    assert results["a-linear"].error is None and results["b-linear"].error is not None
    assert [r["variant"] for r in compare_report(results)] == ["a-linear", "a-linear"]
    with pytest.raises(ValueError, match="duplicate"):
        run_ab_simulation(_variants(("linear", "linear"))[:1] * 2, tmp_path, START, 1,
                          devices=[CPU])


def test_a_pool_splits_into_groups_only_when_it_divides():
    a, b, c, d = (torch.device(f"cpu:{i}") for i in range(4))
    assert _device_groups(2, [a, b, c, d]) == [a, c]
    assert _device_groups(2, [a]) == [a, a]
    assert _device_groups(2, [a, b, c]) == [a, a]
    assert _device_groups(1, [a, b]) == [a]


def test_cli_run_ab_prints_the_table_and_exits_0(tmp_path, capsys):
    assert cli.main(["run-ab", "--store", str(tmp_path), "--days", "1", "--date",
                     "2026-07-01", "--models", "linear", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split()[:2] == ["variant", "date"] and len(lines) == 3
    assert (tmp_path / "a-linear").is_dir()
