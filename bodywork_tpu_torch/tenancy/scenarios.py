"""The scenario zoo: declarative per-tenant data and traffic shapes (the
port's copy of ``bodywork_tpu.tenancy.scenarios``; every spec, seed,
config and profile is the JAX package's, so a tenant's days are the same
threefry draws in both packages).

A :class:`TenantSpec` names a tenant, a DATA scenario, and a TRAFFIC
shape; everything downstream derives deterministically from the spec —
the data scenario maps to a :class:`~bodywork_tpu_torch.data.drift_config.DriftConfig`
(pure function of the spec, so a tenant's fleet run and its solo twin
generate byte-identical datasets), and the traffic shape maps to a
per-tick request-rate profile for the serving harness. Torch-free: specs
are carried by runners, front ends and the cli.

Data scenarios (all ride the existing seeded generator — distinct
tenants differ only through their derived config, never through code
paths, which is what makes the byte-identity soak meaningful):

- ``baseline``             the reference distribution, tenant-seeded
- ``covariate-shift``      the X window slides up-range, so a model
                           trained on another tenant's support is wrong
                           here — the classic serving-skew scenario
- ``seasonality``          strong fast intercept oscillation (drift
                           pressure: models age out within days)
- ``heteroscedastic``      noise scale ramps 1x→3x across the X range
- ``label-delay``          baseline data whose labels arrive
                           ``label_delay_days`` late — the retrain
                           scheduler may only train on days whose labels
                           have landed

Traffic shapes (request-rate multipliers per tick, mean 1.0 except
where the shape's point is the excursion):

- ``steady``       flat 1.0
- ``flash-crowd``  a burst window at ``burst_x`` times base rate —
                   stresses admission sub-budgets and coalescing
- ``retry-storm``  after a trigger tick, excess load decays
                   geometrically — the thundering-herd-with-backoff
                   shape a breached tenant emits
- ``diurnal``      sinusoidal day cycle (the classic serving load curve)
"""
from __future__ import annotations

import dataclasses
import math

from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.store.schema import validate_tenant_id

#: the data scenarios the zoo knows, in catalogue order
SCENARIOS = (
    "baseline",
    "covariate-shift",
    "seasonality",
    "heteroscedastic",
    "label-delay",
)

#: the traffic shapes the zoo knows
TRAFFIC_SHAPES = ("steady", "flash-crowd", "retry-storm", "diurnal")

#: deterministic per-tenant seed derivation: fold the tenant id into the
#: base seed via a stable string hash (NOT Python's salted ``hash``)
_SEED_MOD = 2**31 - 1


def _tenant_seed(tenant_id: str, base_seed: int) -> int:
    h = 0
    for ch in tenant_id.encode("utf-8"):
        h = (h * 131 + ch) % _SEED_MOD
    return (base_seed * 1_000_003 + h) % _SEED_MOD


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's declarative scenario assignment.

    Frozen and torch-free, like :class:`DriftConfig`; the whole fleet
    simulation is a pure function of a tuple of these plus a start date.
    """

    tenant_id: str
    scenario: str = "baseline"
    traffic: str = "steady"
    #: folded with the tenant id into every derived seed, so two fleets
    #: with different base seeds are independent draws end to end
    base_seed: int = 42
    #: rows per simulated day (smaller than the default 1440 keeps
    #: multi-tenant sims cheap)
    n_samples: int = 24 * 60
    #: days between a row being observable (X) and its label (y) landing
    #: — only meaningful for the ``label-delay`` scenario
    label_delay_days: int = 0
    #: flash-crowd burst multiple over base rate
    burst_x: float = 4.0

    def __post_init__(self):
        validate_tenant_id(self.tenant_id)
        if self.scenario not in SCENARIOS:
            raise ValueError(
                f"unknown scenario {self.scenario!r} (want one of {SCENARIOS})"
            )
        if self.traffic not in TRAFFIC_SHAPES:
            raise ValueError(
                f"unknown traffic shape {self.traffic!r} "
                f"(want one of {TRAFFIC_SHAPES})"
            )

    @property
    def seed(self) -> int:
        return _tenant_seed(self.tenant_id, self.base_seed)

    @property
    def effective_label_delay(self) -> int:
        if self.scenario == "label-delay":
            return max(1, self.label_delay_days)
        return max(0, self.label_delay_days)

    def drift_config(self) -> DriftConfig:
        """The tenant's generative model — a pure function of the spec.

        Every scenario derives from the reference distribution by
        parameter changes only, so the generator code path (and its
        seeded determinism) is shared by the whole fleet.
        """
        base = dict(n_samples=self.n_samples, seed=self.seed)
        if self.scenario == "covariate-shift":
            # the X support slides up-range: same slope, disjoint tail
            return DriftConfig(x_low=60.0, x_high=160.0, **base)
        if self.scenario == "seasonality":
            # fast, deep intercept oscillation: ~2.8-day period at the
            # reference's day-of-year clock, amplitude 4x the reference
            return DriftConfig(freq=130.0, amplitude=2.0, kappa=2.0, **base)
        if self.scenario == "heteroscedastic":
            return DriftConfig(hetero=2.0, **base)
        # baseline and label-delay share the reference distribution —
        # label delay is a SCHEDULING property, not a data property
        return DriftConfig(**base)


def traffic_profile(
    spec: TenantSpec, n_ticks: int, base_rps: float = 100.0
) -> list[float]:
    """The tenant's request rate per tick, as absolute rps.

    Deterministic in the spec (burst placement derives from the tenant
    seed), so load harness runs are replayable. ``n_ticks`` is whatever
    granularity the harness drives at — the shapes are resolution-free.
    """
    seed = spec.seed
    out = []
    for t in range(n_ticks):
        if spec.traffic == "steady":
            mult = 1.0
        elif spec.traffic == "flash-crowd":
            # one burst window, ~15% of the run, placed by the seed
            start = seed % max(1, int(n_ticks * 0.7))
            width = max(1, int(n_ticks * 0.15))
            mult = spec.burst_x if start <= t < start + width else 1.0
        elif spec.traffic == "retry-storm":
            # trigger at ~1/3 through, then geometric decay of the
            # excess (clients retrying with backoff)
            trigger = n_ticks // 3
            if t < trigger:
                mult = 1.0
            else:
                mult = 1.0 + (spec.burst_x - 1.0) * (0.7 ** (t - trigger))
        else:  # diurnal
            mult = 1.0 + 0.6 * math.sin(2.0 * math.pi * t / max(1, n_ticks))
        out.append(base_rps * mult)
    return out


def zoo(n_tenants: int, base_seed: int = 42, n_samples: int = 24 * 60) -> tuple:
    """A default fleet: ``n_tenants`` specs cycling through the scenario
    and traffic catalogues — the quickest way to a diverse fleet for
    sims and benches (``tenant-00`` is always baseline/steady)."""
    specs = []
    for i in range(n_tenants):
        specs.append(
            TenantSpec(
                tenant_id=f"tenant-{i:02d}",
                scenario=SCENARIOS[i % len(SCENARIOS)],
                traffic=TRAFFIC_SHAPES[i % len(TRAFFIC_SHAPES)],
                base_seed=base_seed,
                n_samples=n_samples,
                label_delay_days=1 if SCENARIOS[i % len(SCENARIOS)] == "label-delay" else 0,
            )
        )
    return tuple(specs)
