"""Row-queue milliseconds a request: the mean over the window of the
socket transport's front-end submit to dispatcher reply round trip
(``/metrics``: ``bodywork_tpu_rowqueue_wait_seconds``, deltas across the
window). The dispatch is inside it."""
from portbench.metrics_common import histogram_mean_ms


def read(layer):
    if layer.get("kind") != "serve" or not layer.get("metrics_before"):
        return None
    return histogram_mean_ms(layer, "bodywork_tpu_rowqueue_wait_seconds")
