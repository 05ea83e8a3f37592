"""The f32 fused kernel's share of its roofline at the bucket the
requests pad to: the least time the card could take for that forward
(``yardstick.bound``: f32-accurate products at the faster of FFMA and
3xTF32, or the bytes at the memory rate) over the kernel's device time
a launch there, from a device trace of 30 launches of it alone on the
served weights once the service has stopped."""


def read(layer):
    if layer.get("kind") != "serve" or not layer.get("kernel_s"):
        return None
    return 100.0 * layer["kernel_bound_s"] / layer["kernel_s"]
