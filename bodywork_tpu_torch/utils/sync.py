"""The device fence (the port's counterpart of ``bodywork_tpu.utils.sync``).

CUDA launches return before the card has run them, so a timing or an
error check must first wait for the work a result depends on. ``fence``
walks a nested dict/list/tuple of results and synchronizes each CUDA
device that holds a non-empty tensor among them, once: a device runs a
stream's work in launch order, so one synchronize covers every result
queued on it, and a fault the card raised surfaces there. Host tensors,
numpy arrays and other leaves need no wait.
"""
from __future__ import annotations

__all__ = ["fence"]


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    else:
        yield tree


def fence(out):
    """Wait until the card has finished every computation feeding ``out``
    and return ``out``, so it wraps an expression in place:
    ``losses = fence(fn(...))``."""
    devices = []
    for leaf in _leaves(out):
        device = getattr(leaf, "device", None)
        numel = getattr(leaf, "numel", None)
        if getattr(device, "type", None) != "cuda" or not callable(numel) or not numel():
            continue
        if device not in devices:
            devices.append(device)
    if devices:
        import torch

        for device in devices:
            torch.cuda.synchronize(device)
    return out
