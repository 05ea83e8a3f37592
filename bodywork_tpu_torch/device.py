"""Device selection and fencing for the port.

Entry points run on the card: :func:`resolve_device` returns ``cuda``
unless the caller asks for ``"cpu"`` explicitly, and raises where there
is no CUDA device rather than falling back. A scoring service that
silently ran on the CPU would answer every request at a fraction of the
speed its operator sized it for; failing at boot is the honest outcome.

:func:`fence` is the counterpart of ``bodywork_tpu.utils.sync.fence``:
CUDA kernels launch asynchronously, so timing and error-surfacing code
waits for the device with ``torch.cuda.synchronize``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "fence"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, ``cpu``
    only when asked for. Raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and no CUDA device is present.

    Also pins float32 matrix products and convolutions to full IEEE
    float32 (no TF32): the f32 engines are held to the JAX package's
    2e-4 tolerances, which TF32's ~3 decimal digits would not meet.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card "
                "unless asked for the CPU (device='cpu', cli --device cpu)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def fence(out):
    """Wait until every CUDA computation feeding ``out`` (a tensor or a
    nested dict/list/tuple of tensors) has finished. Returns ``out``, so
    it can wrap an expression in place. A device fault raised by a kernel
    surfaces here. CPU tensors are already complete and need nothing."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out
