"""Device kernels a training step launches: the kernels (not copies or
fills) in the device trace of one whole fit, its own set-up included,
over the fit's steps."""


def read(layer):
    trace = layer.get("trace") if layer.get("kind") == "train" else None
    if not trace or not trace["events"]:
        return None
    kernels = [e for e in trace["events"] if not e[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / trace["steps"]
