"""Sharded (data x model) MLP training over a device mesh (the port of
``bodywork_tpu.parallel.train_step``).

JAX's run step for step: the scaler statistics from the full, unpadded
data; the He init from ``split(PRNGKey(seed))``'s first key; the index
stream over the UNPADDED row count, as the JAX scan draws over
``Xs.shape[0]`` (the single-device loop draws over the padded count);
each step's minibatch cut into contiguous chunks over the ``data`` axis,
as ``P("data")`` cuts the index vector; the loss ``sum over shards of
sum((pred - y)^2) / batch``; ``optax.adam`` on every shard's leaves.

The params are Megatron-sharded (``parallel.sharding.mlp_param_sharding``)
over the model axis of the first grid row. Every data row of the process
reads those leaves (a copy where its devices differ), so autograd sums
the rows' gradients into them; across processes the leaves go through
``collectives.replicated``, whose backward all-reduces the gradient, and
process 0's init is broadcast first. The dataset is copied whole onto
each device once: staging is O(dataset), whatever the step count.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bodywork_tpu_torch.data import prng
from bodywork_tpu_torch.device import fence, require_ieee_f32_matmul
from bodywork_tpu_torch.models.base import as_rows
from bodywork_tpu_torch.models.mlp import (
    MLPConfig,
    MLPRegressor,
    _adam_update,
    _masked_stats,
    draw_indices,
    init_mlp_params,
)
from bodywork_tpu_torch.parallel.collectives import (
    broadcast_,
    replicated,
    split_bounds,
    sum_over_processes,
)
from bodywork_tpu_torch.parallel.mesh import Mesh
from bodywork_tpu_torch.parallel.sharding import (
    gather_leaf,
    mlp_param_sharding,
    place_leaf,
    sharded_mlp_forward,
)
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("parallel.train_step")


class _ShardedMLP:
    """The trainable state of a sharded fit: each layer's ``w`` and ``b``
    placed over the first grid row by its spec, and the standardised
    dataset on every device of the process's grid."""

    def __init__(self, net: dict, Xs: torch.Tensor, ys: torch.Tensor, mesh: Mesh):
        self.mesh = mesh
        self.specs = mlp_param_sharding(mesh, {"net": net, "scaler": {}})["net"]["layers"]
        row0 = mesh.devices[0]
        self.layers = [{k: place_leaf(layer[k], spec[k], row0) for k in ("w", "b")}
                       for layer, spec in zip(net["layers"], self.specs)]
        self.leaves = [t for layer in self.layers for k in ("w", "b")
                       for t in (layer[k] if isinstance(layer[k], list) else [layer[k]])]
        for t in self.leaves:
            t.requires_grad_(True)
        with torch.no_grad():
            broadcast_(self.leaves, mesh.group)
        self.data = {d: (Xs.to(d), ys.to(d)) for d in dict.fromkeys(mesh.flat())}

    def _row_layers(self, layers, devices):
        """``layers`` as one grid row reads them: each shard on its device."""
        def to_row(leaf):
            if isinstance(leaf, list):
                return [t.to(d) for t, d in zip(leaf, devices)]
            return leaf.to(devices[0])

        return [{k: to_row(layer[k]) for k in ("w", "b")} for layer in layers]

    def loss(self, idx: torch.Tensor, batch: int, compute_dtype: str | None) -> torch.Tensor:
        """The minibatch loss at ``idx`` (the step's ``batch`` indices):
        each local data row's contiguous chunk through the sharded stack,
        the rows' squared-error sums added, over processes too, then
        divided by the batch."""
        mesh = self.mesh
        group = mesh.group
        layers = [{k: ([replicated(t, group) for t in v] if isinstance(v, list)
                       else replicated(v, group)) for k, v in layer.items()}
                  for layer in self.layers]
        lead = mesh.lead
        bounds = split_bounds(batch, mesh.shape["data"])
        local = bounds[mesh.data_offset:mesh.data_offset + len(mesh.devices)]
        total = torch.zeros((), device=lead)
        for (a, e), devices in zip(local, mesh.devices):
            if a == e:
                continue
            X, y = self.data[devices[0]]
            rows = idx[a:e].to(devices[0])
            pred = sharded_mlp_forward(self._row_layers(layers, devices), X[rows], devices,
                                       compute_dtype)
            total = total + torch.sum((pred - y[rows]) ** 2).to(lead)
        return sum_over_processes(total, group) / max(batch, 1)

    def gathered(self) -> dict:
        """The net's params whole, on the mesh's first device."""
        lead = self.mesh.lead
        return {"layers": [{k: gather_leaf(layer[k], spec[k], lead) for k in ("w", "b")}
                           for layer, spec in zip(self.layers, self.specs)]}


def _standardised(X: np.ndarray, y: np.ndarray, device: torch.device):
    """The scaler from the full, unpadded data (``_masked_stats`` at
    weight 1), and the standardised arrays, on ``device``."""
    Xt, yt = torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)
    w_all = torch.ones(X.shape[0], device=device)
    x_mean, x_std = _masked_stats(Xt, w_all)
    y_mean, y_std = _masked_stats(yt, w_all)
    scaler = {"x_mean": x_mean, "x_std": x_std, "y_mean": y_mean, "y_std": y_std}
    return (Xt - x_mean) / x_std, (yt - y_mean) / y_std, scaler


def sharded_loss_and_grads(net: dict, Xs, ys, idx: torch.Tensor, mesh: Mesh,
                           cfg: MLPConfig):
    """One step's loss at ``net`` (whole params) over the minibatch
    ``idx`` of the standardised ``Xs``/``ys``, sharded over ``mesh`` as
    the fit shards it, and the gradients gathered whole: ``(loss,
    [dw0, db0, dw1, ...])``. A check of the fit's first step."""
    state = _ShardedMLP(net, torch.as_tensor(Xs), torch.as_tensor(ys), mesh)
    loss = state.loss(idx, cfg.batch_size, cfg.compute_dtype)
    grads = torch.autograd.grad(loss, state.leaves)
    it = iter(grads)
    placed = [{k: ([next(it) for _ in v] if isinstance(v, list) else next(it))
               for k, v in layer.items()} for layer in state.layers]
    whole = [gather_leaf(g[k], spec[k], mesh.lead)
             for g, spec in zip(placed, state.specs) for k in ("w", "b")]
    return loss.detach(), whole


def train_mlp_sharded(X, y, cfg: MLPConfig, mesh: Mesh, seed: int | None = None,
                      timings: dict | None = None) -> MLPRegressor:
    """The full data x model training run over ``mesh`` (see the module
    docstring). Returns a fitted :class:`MLPRegressor` whose params are
    gathered whole on the mesh's first device, so it checkpoints and
    serves like a single-device fit; ``final_loss`` is the last step's.

    ``timings``, when given a dict, receives ``staging_s`` (the scaler,
    the init and the dataset's copies, fenced) and ``scan_s`` (the index
    draws and the optimisation loop, fenced)."""
    t_start = time.perf_counter()
    X, y = as_rows(X, y)
    n = X.shape[0]
    lead = mesh.lead
    for dev in dict.fromkeys(mesh.flat()):
        require_ieee_f32_matmul(dev)
    k_init, k_batch = prng.split(prng.PRNGKey(cfg.seed if seed is None else seed))
    Xs, ys, scaler = _standardised(X, y, lead)
    net = init_mlp_params(k_init, (X.shape[1],) + cfg.hidden + (1,), device=lead)
    state = _ShardedMLP(net, Xs, ys, mesh)
    fence([t for pair in state.data.values() for t in pair] + state.leaves)
    t_staged = time.perf_counter()

    idx = draw_indices(k_batch, cfg.n_steps, cfg.batch_size, n, device=lead)
    mu = [torch.zeros_like(p) for p in state.leaves]
    nu = [torch.zeros_like(p) for p in state.leaves]
    losses = torch.empty(cfg.n_steps, device=lead)
    for step in range(cfg.n_steps):
        loss = state.loss(idx[step], cfg.batch_size, cfg.compute_dtype)
        grads = torch.autograd.grad(loss, state.leaves)
        with torch.no_grad():
            _adam_update(state.leaves, list(grads), mu, nu, step + 1, cfg.learning_rate)
            losses[step] = loss
    final_loss = float(losses[-1])
    if timings is not None:
        timings["staging_s"] = t_staged - t_start
        timings["scan_s"] = time.perf_counter() - t_staged
    log.info(f"sharded train: {cfg.n_steps} steps over mesh {mesh.shape}; "
             f"final loss {final_loss:.5f}")
    fitted = MLPRegressor(cfg, {"net": state.gathered(), "scaler": scaler})
    fitted.final_loss = final_loss
    return fitted
