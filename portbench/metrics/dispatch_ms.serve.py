"""Dispatcher milliseconds a dispatch: the mean over the window of the
padded predictor call, graph replay and copy back included (``/metrics``:
``bodywork_tpu_device_dispatch_seconds``, deltas across the window)."""
from portbench.metrics_common import histogram_mean_ms


def read(layer):
    if layer.get("kind") != "serve" or not layer.get("metrics_before"):
        return None
    return histogram_mean_ms(layer, "bodywork_tpu_device_dispatch_seconds")
