"""Arithmetic the ``/metrics`` readers share: deltas across the window
of the service's counters and histogram sums."""


def delta(layer: dict, name: str) -> float:
    return layer["metrics_after"].get(name, 0.0) - layer["metrics_before"].get(name, 0.0)


def histogram_mean_ms(layer: dict, name: str) -> float | None:
    """A histogram's mean over the window, in ms; None where nothing
    was observed."""
    count = delta(layer, f"{name}_count")
    return 1e3 * delta(layer, f"{name}_sum") / count if count else None
