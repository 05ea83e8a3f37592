"""The share of the traced fit's seconds in which no device operation
ran (one whole fit, its set-up included, in the device trace)."""
from portbench.harness import tracesum


def read(layer):
    trace = layer.get("trace") if layer.get("kind") == "train" else None
    if not trace or not trace["events"]:
        return None
    busy, window = tracesum.busy_window(trace)
    return 100.0 * (1.0 - busy / window)
