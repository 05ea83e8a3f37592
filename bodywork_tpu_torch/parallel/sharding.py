"""Sharded serving over a device mesh (the port of
``bodywork_tpu.parallel.sharding``): data-parallel row splitting, and
Megatron-style tensor parallelism for the MLP.

A partition spec is a tuple naming, per dimension, the mesh axis that
splits it: ``(None, "model")`` splits a weight's columns over the model
axis, ``("model", None)`` its rows, ``()`` replicates it. A sharded leaf
is held as a list of its model shards, one tensor on each device of a
grid row; a replicated leaf as one tensor on the row's first device,
where the model axis's sums land. Every data row holds its own copies.

**Programs.** The predictors dispatch through the port's graph cache
(``serve.predictor``), their key carrying the mesh shape and its device
ids (:meth:`_graph_key_extra`), so a same-architecture, same-mesh hot swap
rebinds the new weights to the captured graphs (no capture) and two
meshes never share a graph. When every shard lies on one card (virtual
devices), a bucket's whole sharded forward (the row split, each shard's
products, the model axis's sums, the row concatenation) is ONE CUDA
graph. Over distinct cards each data row is a program of its own on its
row's card (one graph per device; a row whose model shards span cards
runs eagerly, its cross-card copies outside any graph), run one after
another.
"""
from __future__ import annotations

import numpy as np
import torch

from bodywork_tpu_torch.device import require_ieee_f32_matmul
from bodywork_tpu_torch.models.base import Regressor, as_features
from bodywork_tpu_torch.parallel.collectives import (
    gather_columns,
    gather_rows,
    reduce_model,
    split_bounds,
)
from bodywork_tpu_torch.parallel.mesh import Mesh
from bodywork_tpu_torch.serve.predictor import (
    DEFAULT_BUCKETS,
    PaddedPredictor,
    _CapturedProgram,
    _tree_map,
)

COLUMNS = (None, "model")
ROWS = ("model", None)
SPLIT = ("model",)
REPLICATED = ()


def mlp_param_sharding(mesh: Mesh, params: dict) -> dict:
    """Tensor-parallel specs for the MLP params tree: the first layer
    column-parallel, the middle layers row-parallel on their input
    dimension with the bias replicated (their partials summed over
    ``model``), the last (width-1) layer and the scaler replicated."""

    def spec_for_layer(i: int, n_layers: int, leaf: str):
        if i == 0:
            return COLUMNS if leaf == "w" else SPLIT
        if i < n_layers - 1:
            return ROWS if leaf == "w" else REPLICATED
        return REPLICATED

    n_layers = len(params["net"]["layers"])
    layer_specs = [{"w": spec_for_layer(i, n_layers, "w"), "b": spec_for_layer(i, n_layers, "b")}
                   for i in range(n_layers)]
    return {"net": {"layers": layer_specs}, "scaler": {k: REPLICATED for k in params["scaler"]}}


def param_partition_specs(model: Regressor, mesh: Mesh):
    """The specs for serving a model over ``mesh``: the MLP's Megatron
    sharding, full replication for anything else."""
    from bodywork_tpu_torch.models.mlp import MLPRegressor

    if isinstance(model, MLPRegressor):
        return mlp_param_sharding(mesh, model.params)
    return _tree_map(lambda _: REPLICATED, model.params)


def _round_buckets_to_axis(buckets, n_data: int) -> tuple[int, ...]:
    """Round each bucket up to a multiple of the data axis, so every
    padded batch splits evenly over it."""
    return tuple(sorted({b + (-b) % n_data for b in buckets}))


def _copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.detach().to(device, copy=True).contiguous()


def place_leaf(t: torch.Tensor, spec: tuple, devices) -> torch.Tensor | list:
    """``t`` laid over one grid row's ``devices`` by ``spec``: a list of
    its model shards, or (replicated) one copy on ``devices[0]``."""
    if "model" not in spec:
        return _copy(t, devices[0])
    dim = spec.index("model")
    return [_copy(t.narrow(dim, a, b - a), d)
            for (a, b), d in zip(split_bounds(t.shape[dim], len(devices)), devices)]


def gather_leaf(leaf, spec: tuple, device: torch.device) -> torch.Tensor:
    """A placed leaf whole again, on ``device``."""
    if "model" not in spec:
        return leaf.detach().to(device)
    return torch.cat([p.detach().to(device) for p in leaf], dim=spec.index("model"))


def place_tree(tree, specs, devices):
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], devices) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [place_tree(v, s, devices) for v, s in zip(tree, specs)]
    return place_leaf(tree, specs, devices)


def sharded_mlp_forward(layers: list, x: torch.Tensor, devices,
                        compute_dtype: str | None = None) -> torch.Tensor:
    """The dense stack over one grid row's placed ``layers``, ``x`` on
    ``devices[0]``: a column-parallel layer (weight and bias both split)
    leaves its activations split by column; a row-parallel one (weight
    split, bias whole) multiplies each column shard by its weight shard
    and sums the partials over the model axis; a replicated one reads
    whole activations. With one model shard this is ``mlp_forward``'s
    arithmetic, op for op."""
    dtype = getattr(torch, compute_dtype) if compute_dtype else None
    cast = (lambda a: a.to(dtype)) if dtype else (lambda a: a)
    lead = devices[0]
    h, split = cast(x), False
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        if isinstance(w, list) and isinstance(b, list):
            h = [h.to(d) @ cast(wm) + cast(bm) for d, wm, bm in zip(devices, w, b)]
            split = True
        elif isinstance(w, list):
            if not split:
                bounds = split_bounds(h.shape[1], len(w))
                h = [h[:, a:e].to(d) for (a, e), d in zip(bounds, devices)]
            h = reduce_model([hm @ cast(wm) for hm, wm in zip(h, w)], lead) + cast(b)
            split = False
        else:
            if split:
                h = gather_columns(h, lead)
            h = h @ cast(w) + cast(b)
            split = False
        if i < len(layers) - 1:
            h = [torch.relu(t) for t in h] if split else torch.relu(h)
    if split:
        h = gather_columns(h, lead)
    return h[:, 0].to(torch.float32)


def sharded_mlp_apply(weights: dict, x: torch.Tensor, devices) -> torch.Tensor:
    """``mlp_apply`` over one grid row's placed params: the scaler, the
    sharded stack, the output scaled back."""
    s = weights["scaler"]
    h = (x - s["x_mean"]) / s["x_std"]
    out = sharded_mlp_forward(weights["net"]["layers"], h, devices)
    return out * s["y_std"] + s["y_mean"]


def _plain_row_fn(apply):
    return lambda weights, x, devices: apply(weights, x)


def _row_runner(row_fn, weights, devices):
    return lambda X: row_fn(weights, X, devices)


def _mesh_runner(row_fn, rows_weights, grid):
    """``X -> y`` over the whole local grid: rows split contiguously over
    the data axis, each row's forward on its devices, the rows
    concatenated on the grid's first device."""
    lead = grid[0][0]

    def run(X: torch.Tensor) -> torch.Tensor:
        bounds = split_bounds(X.shape[0], len(grid))
        outs = [row_fn(w, X[a:e].to(devs[0]), devs)
                for (a, e), w, devs in zip(bounds, rows_weights, grid)]
        return gather_rows(outs, lead)

    return run


class _RowsProgram:
    """One bucket's program over distinct cards: each data row's forward
    a program of its own on its row's card, run one after another."""

    def __init__(self, slot, row_fn, grid, bucket: int, n_features: int):
        self.slot = slot
        self.engine = None
        bounds = split_bounds(bucket, len(grid))
        self.bounds = bounds
        self.rows = [
            _CapturedProgram(_row_runner(row_fn, w, devs), (e - a, n_features), devs[0],
                             capture=len(set(devs)) == 1)
            for (a, e), w, devs in zip(bounds, slot.weights["rows"], grid)
        ]
        self.graph = self.rows[0].graph

    def run(self, Xp: np.ndarray, owner: int, weights, cache) -> np.ndarray:
        slot = self.slot
        slot.acquire()
        try:
            slot.bind(owner, weights, cache)
            return np.concatenate([
                program.run(Xp[a:e], lambda: cache.count_replay(None))
                for (a, e), program in zip(self.bounds, self.rows)])
        finally:
            slot.release()


def _refuse_multiprocess(mesh: Mesh) -> None:
    if mesh.group is not None:
        raise ValueError(f"serving over a multi-process mesh ({mesh.label}) is not "
                         "supported; serve over one process's devices")


class DataParallelPredictor(PaddedPredictor):
    """A :class:`PaddedPredictor` whose bucket programs split rows over the
    mesh's ``data`` axis, params copied whole onto each row (the serving
    path of BASELINE.json config 4)."""

    def __init__(self, model: Regressor, mesh: Mesh,
                 buckets: tuple[int, ...] | None = None):
        _refuse_multiprocess(mesh)
        if buckets is None:
            buckets = (64, 512, 4096)
        super().__init__(model, _round_buckets_to_axis(buckets, mesh.shape["data"]))
        self.mesh = mesh
        self.device = mesh.lead
        for dev in set(mesh.flat()):
            require_ieee_f32_matmul(dev)
        self._weights = {"rows": [place_tree(model.params, self._specs(), row)
                                  for row in mesh.devices]}

    def _specs(self):
        return _tree_map(lambda _: REPLICATED, self.model.params)

    def _row_fn(self):
        return _plain_row_fn(type(self.model).apply)

    @property
    def shard_params(self) -> list:
        """Each data row's placed params."""
        return self._weights["rows"]

    def _graph_weights(self):
        return self._weights

    def _graph_runner(self, weights):
        return _mesh_runner(self._row_fn(), weights["rows"], self.mesh.devices)

    def _graph_key_extra(self) -> tuple:
        # the mesh shape AND its devices: two meshes never share a program
        return (tuple(self.mesh.shape.items()), self.mesh.device_ids())

    def _build_program(self, slot, bucket: int, n_features: int):
        if self.mesh.one_device():
            return super()._build_program(slot, bucket, n_features)
        return _RowsProgram(slot, self._row_fn(), self.mesh.devices, bucket, n_features)


class ShardedMLPPredictor(DataParallelPredictor):
    """Mesh-sharded serving: an MLP's weights Megatron-sharded on the
    ``model`` axis (:func:`mlp_param_sharding`), rows split on ``data``,
    through the graph cache (see the module docstring). Each dispatch
    counts ``bodywork_tpu_serve_sharded_dispatch_total{mesh="DxM"}``. A
    data-parallel mesh's rows are the single-device program's rows at the
    shard's own shape."""

    def __init__(self, model: Regressor, mesh: Mesh,
                 buckets: tuple[int, ...] | None = None):
        from bodywork_tpu_torch.models.mlp import MLPRegressor

        if mesh.shape["model"] > 1 and not isinstance(model, MLPRegressor):
            raise ValueError(
                f"tensor-parallel serving (mesh model axis {mesh.shape['model']}) "
                f"requires an MLP; got {model.info}"
            )
        super().__init__(model, mesh, DEFAULT_BUCKETS if buckets is None else buckets)
        self._dispatch_counter = None

    def _specs(self):
        return param_partition_specs(self.model, self.mesh)

    def _row_fn(self):
        from bodywork_tpu_torch.models.mlp import MLPRegressor

        if isinstance(self.model, MLPRegressor):
            return sharded_mlp_apply
        return super()._row_fn()

    def _graph_key_extra(self) -> tuple:
        return ("sharded",) + super()._graph_key_extra()

    def _predict_padded(self, Xp: np.ndarray) -> np.ndarray:
        if self._dispatch_counter is None:
            from bodywork_tpu_torch.obs import get_registry

            self._dispatch_counter = get_registry().counter(
                "bodywork_tpu_serve_sharded_dispatch_total",
                "Padded device dispatches executed through a mesh-sharded "
                "serving predictor, by mesh shape (data x model)",
            )
        self._dispatch_counter.inc(mesh=self.mesh.label)
        return super()._predict_padded(Xp)


def make_data_parallel_apply(model: Regressor, mesh: Mesh):
    """The sharded apply, run eagerly: params copied onto each grid row
    once, rows split over the ``data`` axis. Returns ``(dispatch,
    n_data)``: ``dispatch(X)`` pads the batch to a multiple of the data
    axis and returns the result as a tensor on the mesh's first device,
    not fetched."""
    if type(model).apply is None:
        raise TypeError(f"{type(model).__name__} does not define an apply function")
    _refuse_multiprocess(mesh)
    specs = _tree_map(lambda _: REPLICATED, model.params)
    rows = [place_tree(model.params, specs, row) for row in mesh.devices]
    run = _mesh_runner(_plain_row_fn(type(model).apply), rows, mesh.devices)
    n_data = mesh.shape["data"]

    def dispatch(X):
        X = as_features(X)
        pad = (-X.shape[0]) % n_data
        if pad:
            X = np.concatenate([X, np.zeros((pad, X.shape[1]), X.dtype)])
        with torch.no_grad():
            return run(torch.as_tensor(X, device=mesh.lead))

    return dispatch, n_data


def make_data_parallel_predict(model: Regressor, mesh: Mesh):
    """A predict function sharding rows over the mesh's ``data`` axis,
    fetching the result to the host."""
    dispatch, _ = make_data_parallel_apply(model, mesh)

    def predict(X) -> np.ndarray:
        X = as_features(X)
        return dispatch(X).cpu().numpy()[:X.shape[0]]

    return predict

