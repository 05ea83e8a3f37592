"""Front-end milliseconds a request: the mean over the window of the
front ends' parse and serialize phases (``/metrics``:
``bodywork_tpu_request_parse_seconds`` plus
``bodywork_tpu_response_serialize_seconds``, deltas across the window)."""
from portbench.metrics_common import delta, histogram_mean_ms


def read(layer):
    if layer.get("kind") != "serve" or not layer.get("metrics_before"):
        return None
    count = delta(layer, "bodywork_tpu_request_parse_seconds_count")
    if not count:
        return None
    return (histogram_mean_ms(layer, "bodywork_tpu_request_parse_seconds")
            + 1e3 * delta(layer, "bodywork_tpu_response_serialize_seconds_sum") / count)
