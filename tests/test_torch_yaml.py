"""The port's YAML subset (``bodywork_tpu_torch.pipeline._yaml``) against
pyyaml: ``dump`` byte-equal to ``yaml.safe_dump(doc, sort_keys=False)``,
``load`` equal to ``yaml.safe_load``, on every spec and manifest either
package emits, on random documents of the subset, and refusals outside
it."""
from __future__ import annotations

import math

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from bodywork_tpu_torch.pipeline import _yaml


def _same(a, b) -> bool:
    """Equality that takes NaN as equal to itself."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _round_trip(doc) -> str:
    want = yaml.safe_dump(doc, sort_keys=False)
    got = _yaml.dump(doc)
    assert got == want
    assert _same(_yaml.load(got), yaml.safe_load(want))
    return got


def _jax_documents():
    from bodywork_tpu.pipeline import default_pipeline, generate_manifests

    for model in ("linear", "mlp"):
        for mode in ("single", "batch"):
            for overlap in (False, True):
                spec = default_pipeline(model, mode, overlap_generate=overlap)
                yield f"jax-spec-{model}-{mode}-{overlap}", yaml.safe_load(spec.to_yaml())
                for kw in ({}, {"store_volume": "hostpath"}, {"store_path": "gs://b/p"},
                           {"daily_schedule": None}):
                    for name, doc in generate_manifests(spec, **kw).items():
                        yield f"jax-{model}-{mode}-{overlap}-{sorted(kw)}-{name}", doc


def _port_documents():
    from bodywork_tpu_torch.pipeline import default_pipeline, generate_manifests

    for model in ("linear", "mlp"):
        for mode in ("single", "batch"):
            for overlap in (False, True):
                spec = default_pipeline(model, mode, overlap_generate=overlap)
                yield f"port-spec-{model}-{mode}-{overlap}", _yaml.load(spec.to_yaml())
                for kw in ({}, {"store_volume": "hostpath"}, {"store_path": "gs://b/p"},
                           {"daily_schedule": None}):
                    for name, doc in generate_manifests(spec, **kw).items():
                        yield f"port-{model}-{mode}-{overlap}-{sorted(kw)}-{name}", doc


@pytest.mark.parametrize("source", ["jax", "port"])
def test_every_emitted_document_dumps_and_loads_as_pyyaml_does(source):
    docs = list(_jax_documents() if source == "jax" else _port_documents())
    assert len(docs) > 100
    for _name, doc in docs:
        _round_trip(doc)


def test_the_spec_texts_of_both_packages_load_as_pyyaml_loads_them():
    """``to_yaml`` of either package (the ConfigMap's text), the legacy
    ``secrets: - sentry-integration`` form and its flow spelling."""
    from bodywork_tpu.pipeline import default_pipeline as jax_pipeline

    from bodywork_tpu_torch.pipeline import default_pipeline

    for text in (jax_pipeline("mlp").to_yaml(), default_pipeline("mlp").to_yaml()):
        assert _yaml.load(text) == yaml.safe_load(text)
        legacy = text.replace("optional_secrets:\n    - sentry-integration",
                              "secrets:\n    - sentry-integration")
        assert "optional_secrets" not in legacy
        assert _yaml.load(legacy) == yaml.safe_load(legacy)
        flow = text.replace("optional_secrets:\n    - sentry-integration",
                            "secrets: [sentry-integration]")
        assert _yaml.load(flow) == yaml.safe_load(flow)


@pytest.mark.parametrize("value", [
    "x" * 111, "x\ny\n", "true", "", "1", "0.5", "1e3", "yes", "No", "~", "null", "a: b",
    "- x", "#x", "x #y", "x#y", ":x", "x:", "?", "? x", "-", "-x", "'q'", '"dq"', "a'b",
    "2026-01-01", "0x1F", "0o7", "012", "1_000", "+1", ".inf", "-.INF", ".NaN", "<<", "=",
    " lead", "trail ", "two  spaces", "a \nb", "a\n b", "\n", "\n\nx\n\n",
    "hello world " * 12, "w" * 79 + " " + "z" * 10, "---x", "...", "a,b", "[x]", "{x}",
    "x" * 70 + '"' + " y" * 20, "x\\y " * 30, "p:q " * 25,
])
def test_scalar_styles_match_pyyaml(value):
    _round_trip({"k": value, "seq": [value, {"in": value}], "nested": {"deep": [value]}})


@pytest.mark.parametrize("value", [0, -7, 10**30, True, False, None, 0.5, -0.0, 1e20, 1e-5,
                                   3.141592653589793, math.inf, -math.inf, math.nan, 1e16])
def test_non_string_scalars_match_pyyaml(value):
    _round_trip({"k": value, "s": [value]})


def test_shared_collections_become_anchors_and_aliases():
    labels = {"app": "x", "part-of": "y"}
    items = ["a", "b"]
    doc = {"meta": {"labels": labels}, "spec": {"template": {"labels": labels}},
           "l1": items, "l2": [items, items], "empty": {}, "again": labels}
    text = _round_trip(doc)
    assert "&id001" in text and "*id001" in text and "&id002" in text
    loaded = _yaml.load(text)
    assert loaded["meta"]["labels"] is loaded["spec"]["template"]["labels"]


_KEYS = st.text(alphabet="abc-_./: '\"#x1", min_size=1, max_size=12)
_TEXT = st.text(alphabet=st.sampled_from(list("ab xyz:#-'\"\\,[]{}&*!|>%@`?.01e+\n")),
                max_size=120)
_SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(min_value=-10**20, max_value=10**20),
    st.floats(allow_nan=True, allow_infinity=True), _TEXT,
    st.sampled_from(["true", "yes", "null", "", "1.5", "0", "2026-07-01", "x" * 95,
                     "word " * 30, "a\n\nb", " ", "'", '"']),
)
_DOCS = st.recursive(
    _SCALARS,
    lambda children: st.one_of(st.lists(children, max_size=4),
                               st.dictionaries(_KEYS, children, max_size=4)),
    max_leaves=25,
)


# derandomized: the same examples every run (a run of 12,000 random ones
# found no difference)
@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.dictionaries(_KEYS, _DOCS, max_size=5))
def test_random_documents_of_the_subset_match_pyyaml(doc):
    _round_trip(doc)


@settings(max_examples=100, deadline=None, derandomize=True)
@given(st.dictionaries(_KEYS, st.lists(_SCALARS, min_size=1, max_size=3), min_size=1,
                       max_size=4), st.data())
def test_random_shared_references_match_pyyaml(doc, data):
    shared = data.draw(st.sampled_from(list(doc.values())))
    doc = {**doc, "zz-shared-1": shared, "zz-shared-2": {"in": shared}}
    _round_trip(doc)


@pytest.mark.parametrize("doc", [
    {"k": (1, 2)}, {"k": b"bytes"}, {1: "int key"}, {"k": "tab\there"}, {"k": "caf\u00e9"},
    {"k": "\r"}, {"": "empty key"}, {"x" * 128: 1}, {"multi\nline": 1}, {"k": object()},
    ["a root list"],
])
def test_dump_refuses_outside_the_subset(doc):
    with pytest.raises(ValueError, match="YAML subset"):
        _yaml.dump(doc)


@pytest.mark.parametrize("text,where", [
    ("a: !!str x\n", "line 1"), ("a: |\n  x\n", "line 1"), ("a: 1 # c\n", "line 1"),
    ("# c\na: 1\n", ""), ("a: 2026-01-01\n", "line 1"), ("a: 0x10\n", "line 1"),
    ("? a\n: b\n", "line 1"), ("a: {b: 1}\n", "line 1"), ("a: 1\n\nb: 2\n", "line 2"),
    ("a:\tb\n", ""), ("---\na: 1\n", "line 1"), ("a: &x 1\n", "line 1"),
    ("a: *missing\n", "line 1"), ("a: 1\na: 2\n", "line 2"), ("a:\n", "line 1"),
    ("a: 1\n   b: 2\n", "line 1"), ("a: 1:30\n", "line 1"), ("a: <<\n", "line 1"),
    ('a: "x\\ty"\n', "line 1"), ('a: "\\x41"\n', "line 1"),
])
def test_load_refuses_outside_the_subset(text, where):
    with pytest.raises(ValueError, match="YAML subset") as info:
        _yaml.load(text)
    assert where in str(info.value)
