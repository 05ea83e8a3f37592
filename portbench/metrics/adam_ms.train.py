"""Device milliseconds a step of the optimizer's foreach kernels
(``multi_tensor_apply``, the Adam update's ``torch._foreach_*`` ops) in
the device trace of one whole fit."""
from portbench.harness import tracesum


def read(layer):
    trace = layer.get("trace") if layer.get("kind") == "train" else None
    if not trace:
        return None
    seconds = sum(s for name, (s, _n) in tracesum.seconds_by_name(trace).items()
                  if "multi_tensor_apply" in name)
    return 1e3 * seconds / trace["steps"] if seconds > 0 else None
