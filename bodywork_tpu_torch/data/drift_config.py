"""The generative-model parameter set (a copy of
``bodywork_tpu.data.drift_config``; defaults = reference
``stage_3:19,36-38``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Generative-model parameters (defaults = reference ``stage_3:19,36-38``)."""

    n_samples: int = 24 * 60          # rows sampled per simulated day
    beta: float = 0.5                 # slope
    sigma: float = 10.0               # noise scale
    freq: float = 6.0                 # intercept cycles per year
    kappa: float = 1.0                # intercept mean
    amplitude: float = 0.5            # intercept oscillation amplitude
    x_low: float = 0.0
    x_high: float = 100.0
    seed: int = 42                    # global seed folded with the date
    #: heteroscedasticity: noise scale grows linearly with x, from
    #: ``sigma`` at ``x_low`` to ``sigma * (1 + hetero)`` at ``x_high``;
    #: 0.0 (the default) is the homoscedastic reference sampler
    hetero: float = 0.0
