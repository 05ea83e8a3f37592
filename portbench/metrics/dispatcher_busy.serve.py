"""The dispatcher's CPU seconds over the window, from its
``/proc/<pid>/stat``, as a share of the window: how near the one
process that drives the card is to a whole core."""


def read(layer):
    if layer.get("kind") != "serve" or "dispatcher" not in layer.get("cpu_s", {}):
        return None
    return 100.0 * layer["cpu_s"]["dispatcher"] / layer["window_s"]
