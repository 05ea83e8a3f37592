"""The cross-shard operations of the mesh, written out: what XLA derived
from the JAX package's shardings.

Inside one process every shard is a tensor on its grid device, so the
model axis's partial sums and the data axis's concatenation are plain
PyTorch (:func:`reduce_model`, :func:`gather_columns`,
:func:`gather_rows`), and autograd differentiates them, the copies
between devices included. Across processes only the data axis runs, and
the two collectives it needs carry their own gradients, the
Megatron ``f``/``g`` pair: :func:`replicated` (identity forward,
all-reduce of the gradient backward: DDP's reduction written out) and
:func:`sum_over_processes` (all-reduce forward, identity backward).
:func:`broadcast_` copies process 0's initial params to every process.
"""
from __future__ import annotations

import torch


def split_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous ``[start, stop)`` ranges cutting ``n`` into ``parts``
    chunks as a sharded dimension is cut: ``ceil(n / parts)`` each, the
    last ones shorter (empty where ``n`` runs out)."""
    size = -(-n // parts)
    return [(min(i * size, n), min((i + 1) * size, n)) for i in range(parts)]


def reduce_model(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of the model axis's partial products, in shard order, on
    ``device``."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = out + part.to(device)
    return out


def gather_columns(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Column shards concatenated whole on ``device`` (an all-gather over
    the model axis)."""
    return torch.cat([p.to(device) for p in parts], dim=1)


def gather_rows(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The data axis's row shards concatenated on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=0)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverProcesses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        import torch.distributed as dist

        out = tensor.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def replicated(tensor: torch.Tensor, group) -> torch.Tensor:
    """A param replicated over processes as the forward reads it: itself;
    backward, its gradient summed over ``group`` (None: no group, the
    tensor unchanged)."""
    return tensor if group is None else _Replicated.apply(tensor, group)


def sum_over_processes(tensor: torch.Tensor, group) -> torch.Tensor:
    """``tensor`` summed over ``group``'s processes; its gradient passes
    through to each process's own term (None: no group, unchanged)."""
    return tensor if group is None else _SumOverProcesses.apply(tensor, group)


def broadcast_(tensors, group) -> None:
    """Overwrite ``tensors`` in place with process 0's (a no-op without a
    group)."""
    if group is None:
        return
    import torch.distributed as dist

    for t in tensors:
        dist.broadcast(t, src=0, group=group)
