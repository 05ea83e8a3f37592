"""The pipeline's MLP regressor on torch (the port of
``bodywork_tpu.models.mlp``, serving side).

Parameters keep the JAX package's layout: ``MLPNet`` holds each dense
layer's ``w`` as an ``(in, out)`` matrix and ``b`` as ``(out,)``, so the
checkpoint leaf paths ``net/layers/<i>/w|b`` and ``scaler/*`` map one to
one onto :attr:`MLPRegressor.params`, and the fused kernel reads each
``w`` as K x N row-major with no transpose. The standardisation scaler is
folded into the params (``x_mean``/``x_std``/``y_mean``/``y_std``), so
serving needs no side-channel state.

Training (the Adam loop, ``fit``, ``fine_tune``) is a later slice; here
weights come from a checkpoint, or from :func:`init_mlp_params` for a
randomly initialised model of a given width.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from bodywork_tpu_torch.models.base import Regressor


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    # the same fields and defaults as the JAX config, so a checkpoint's
    # config JSON loads in either package
    hidden: tuple[int, ...] = (64, 64)
    learning_rate: float = 1e-2
    batch_size: int = 256
    n_steps: int = 2000
    seed: int = 0
    compute_dtype: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "hidden", tuple(self.hidden))


class Dense(nn.Module):
    """One dense layer, ``h @ w + b``, with ``w`` in (in, out) layout."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        # serving-only parameters: no autograd graph on the request path
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = nn.Parameter(b, requires_grad=False)


class MLPNet(nn.Module):
    """The dense stack's parameters (the ``net`` subtree); the forward
    pass is :func:`mlp_forward` over :meth:`params`."""

    def __init__(self, layers: list[dict]):
        super().__init__()
        self.layers = nn.ModuleList(Dense(layer["w"], layer["b"]) for layer in layers)

    def params(self) -> dict:
        return {"layers": [{"w": layer.w, "b": layer.b} for layer in self.layers]}


def init_mlp_params(generator: torch.Generator, sizes: tuple[int, ...],
                    device=None) -> dict:
    """He-initialised dense stack; sizes = (in, *hidden, out). The
    counterpart of the JAX ``init_mlp_params`` (``mlp.py:49-56``): the
    same distribution, drawn from ``generator`` instead of a JAX key."""
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(
            (fan_in, fan_out), generator=generator, device=device
        ) * float(np.sqrt(2.0 / fan_in))
        layers.append({"w": w, "b": torch.zeros((fan_out,), device=device)})
    return {"layers": layers}


def mlp_forward(net_params: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense->relu stack; returns (n,) predictions in standardised space."""
    layers = net_params["layers"]
    h = x
    for layer in layers[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    out = h @ layers[-1]["w"] + layers[-1]["b"]
    return out[:, 0]


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Full apply incl. the folded-in scaler: raw X -> raw prediction, in
    float32 (the ``torch`` serving engine; the JAX ``xla`` engine)."""
    s = params["scaler"]
    h = (x - s["x_mean"]) / s["x_std"]
    out = mlp_forward(params["net"], h)
    return out * s["y_std"] + s["y_mean"]


def _masked_stats(v: torch.Tensor, w: torch.Tensor):
    """Weighted mean and std (std floored at 1e-6) over rows with
    weight 1 — the scaler statistics (``mlp.py:155-160``)."""
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(v * w) / n
    var = torch.sum(w * (v - mean) ** 2) / n
    return mean, torch.clamp(torch.sqrt(var), min=1e-6)


def params_from_jax(host_params, device=None):
    """JAX host params (a nested dict/list of numpy arrays, e.g. a
    checkpoint's unflattened leaves) -> the same structure of float32
    tensors on ``device``: the function that carries weights across."""
    if isinstance(host_params, dict):
        return {k: params_from_jax(v, device) for k, v in host_params.items()}
    if isinstance(host_params, (list, tuple)):
        return [params_from_jax(v, device) for v in host_params]
    arr = np.array(host_params, dtype=np.float32, copy=True)
    return torch.from_numpy(arr).to(device)


def params_to_host(params):
    """Port params -> nested numpy arrays (the inverse of
    :func:`params_from_jax`)."""
    if isinstance(params, dict):
        return {k: params_to_host(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_host(v) for v in params]
    return params.detach().cpu().numpy()


class MLPRegressor(Regressor):
    model_type = "mlp"

    def __init__(self, config: MLPConfig | None = None, params: dict | None = None):
        super().__init__(config or MLPConfig())
        if params is None:
            raise ValueError(
                "MLPRegressor needs params: training is a later slice of "
                "the port, so load a checkpoint or use init_mlp_params"
            )
        self.net = MLPNet(params["net"]["layers"])
        self.scaler = dict(params["scaler"])

    @property
    def params(self) -> dict:
        return {"net": self.net.params(), "scaler": self.scaler}

    @property
    def device(self) -> torch.device:
        return self.net.layers[0].w.device

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = torch.as_tensor(np.asarray(X, dtype=np.float32), device=self.device)
        if X.ndim == 1:
            X = X[:, None]
        return mlp_apply(self.params, X).cpu().numpy()

    @property
    def n_features(self) -> int:
        return int(self.net.layers[0].w.shape[0])

    @property
    def info(self) -> str:
        return f"MLPRegressor(hidden={list(self.config.hidden)})"

    @classmethod
    def from_config_dict(cls, cfg: dict, params) -> "MLPRegressor":
        cfg = dict(cfg)
        cfg["hidden"] = tuple(cfg.get("hidden", (64, 64)))
        return cls(MLPConfig(**cfg), params)
