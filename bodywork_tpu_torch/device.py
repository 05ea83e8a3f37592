"""Device selection and fencing for the port.

Entry points run on the card: :func:`resolve_device` returns ``cuda``
unless the caller asks for ``"cpu"`` explicitly, and raises where there
is no CUDA device rather than falling back. A scoring service that
silently ran on the CPU would answer every request at a fraction of the
speed its operator sized it for; failing at boot is the honest outcome.

:func:`fence` is the counterpart of ``bodywork_tpu.utils.sync.fence``:
CUDA kernels launch asynchronously, so timing and error-surfacing code
waits for the device with ``torch.cuda.synchronize``.

Matrix-product precision: the port's float32 products (training, the
linear fit, the plain ``torch`` engine) run at full IEEE float32, because
they are held to the JAX package's float32 tolerances, which TF32's ~3
decimal digits would miss. The port never changes PyTorch's process-wide
TF32 switches itself: :func:`require_ieee_f32_matmul` refuses to run
those products on the card when the caller's process has TF32 on, and
:func:`matmul_precision` reports the settings in force.
"""
from __future__ import annotations

import torch

__all__ = ["fence", "matmul_precision", "require_ieee_f32_matmul", "resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, ``cpu``
    only when asked for. Raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and no CUDA device is present.
    """
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


def matmul_precision() -> dict:
    """PyTorch's float32 matrix-product settings in force in this process."""
    return {
        "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


def require_ieee_f32_matmul(device: torch.device) -> None:
    """Refuse float32 products on the card while the process has TF32
    (or bf16) float32 products switched on: the port's f32 paths are held
    to IEEE float32. CPU products are always IEEE float32."""
    if device.type != "cuda":
        return
    setting = matmul_precision()
    if setting["allow_tf32"] or setting["float32_matmul_precision"] != "highest":
        raise RuntimeError(
            f"float32 matrix products are set to reduced precision in this "
            f"process ({setting}); the port's float32 paths need IEEE float32: "
            "set torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')"
        )


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
