"""The serving control plane (the port of ``bodywork_tpu.tune``): a
learned cost model over observed traces that closes the loop on the
hand-set serving knobs.

- :mod:`bodywork_tpu_torch.tune.collect` — the trace collector: obs
  registry snapshots, day-report spans and ``traffic run`` request and
  results logs normalise into one
  :class:`~bodywork_tpu_torch.tune.collect.ObservationTable`, plus the
  dispatch-cost probe (the one piece that runs on the card);
- :mod:`bodywork_tpu_torch.tune.model` — the analytical and fitted model:
  a pure function of the table -> a tuned knob set with a per-knob
  decision trace;
- :mod:`bodywork_tpu_torch.tune.config` — the tuned-config document under
  ``tuning/``, consumed by ``serve`` and the serve stage through the
  malformed-degrades resolver
  (:func:`~bodywork_tpu_torch.tune.config.resolve_serving_knobs`);
- :mod:`bodywork_tpu_torch.tune.costmodel` — the learned dispatch-cost
  model: a seeded closed-form ridge over probe samples, float64 numpy on
  the host, pricing unprobed ladder rungs for the fitter and each request
  for the admission layer's cost-priced shed;
- :mod:`bodywork_tpu_torch.tune.online` — the online re-tune controller
  on the reload watcher's polls: incremental log ingestion, drift, a
  mid-flight apply and the config guard that reverts a regressing config
  in one CAS (``registry/configlog.py``).

Only the config layer is re-exported here. None of these modules imports
torch; the probe loads it inside the call, so fsck, the CLI parser and
the serve stage's boot stay light.
"""
from bodywork_tpu_torch.tune.config import (
    KNOB_DEFAULTS,
    TUNED_CONFIG_ENV,
    TUNED_CONFIG_SCHEMA,
    TUNED_KNOB_ENV,
    ResolvedKnobs,
    load_tuned_config,
    resolve_serving_knobs,
    validate_knobs,
    write_tuned_config,
)

__all__ = [
    "KNOB_DEFAULTS",
    "TUNED_CONFIG_ENV",
    "TUNED_CONFIG_SCHEMA",
    "TUNED_KNOB_ENV",
    "ResolvedKnobs",
    "load_tuned_config",
    "resolve_serving_knobs",
    "validate_knobs",
    "write_tuned_config",
]
