"""The pipeline's MLP regressor on torch (the port of
``bodywork_tpu.models.mlp``): He init, minibatch Adam training and the
serving apply.

Parameters keep the JAX package's layout: ``MLPNet`` holds each dense
layer's ``w`` as an ``(in, out)`` matrix and ``b`` as ``(out,)``, so the
checkpoint leaf paths ``net/layers/<i>/w|b`` and ``scaler/*`` map one to
one onto :attr:`MLPRegressor.params`, and the fused kernel reads each
``w`` as K x N row-major with no transpose. The standardisation scaler is
folded into the params (``x_mean``/``x_std``/``y_mean``/``y_std``), so
serving needs no side-channel state.

Training is the JAX package's ``lax.scan`` loop as a Python loop of
plain torch ops with autograd (``mlp.py:108-130``): each step gathers a
minibatch by index, takes the gradient of the weighted MSE and applies
Adam as ``optax.adam(lr)`` configures it (b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias-corrected). In float32 the large weight
gradients run on the tensor cores, f32-accurate
(:mod:`bodywork_tpu_torch.ops.train_gemm`). ``compute_dtype="bfloat16"``
casts the matmul operands to bf16; params, optimizer state and loss stay
f32.

The seeded draws are the JAX package's, on any device: the He init and
the minibatch index stream come from ``jax.random``'s threefry
(:mod:`bodywork_tpu_torch.data.prng`) under the keys the JAX package
derives from ``PRNGKey(seed)``. The index stream is drawn up front as an
``(n_steps, batch)`` tensor over the PADDED row count, so padding rows
are drawn with weight 0 exactly as in the JAX loop: :func:`draw_indices`
walks the scan's key chain on the host and hashes every step's indices
in one batched pass on the model's device.

A fit records its phases as spans on the recorder a caller installed with
:func:`bodywork_tpu_torch.obs.spans.recording` (:class:`FitPhases`): the
host's set-up, the first :data:`HEAD_STEPS` steps' enqueues one by one,
the dispatch of the whole loop and the drain to the loss on the host.
Each phase is a ``record_function`` range too, so a profile shows it
beside the kernels. With no recorder and no profiler a fit records
nothing, and a step pays one boolean test.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import numpy as np
import torch
from torch import nn

from bodywork_tpu_torch.data import prng
from bodywork_tpu_torch.device import require_ieee_f32_matmul, resolve_device
from bodywork_tpu_torch.models.base import Regressor, as_rows, pad_rows
from bodywork_tpu_torch.obs.spans import CATEGORY_FIT, SpanRecorder, current_recorder
from bodywork_tpu_torch.ops.train_gemm import kernel_layers, step_products, train_product
from bodywork_tpu_torch.utils.profiling import annotate

#: Adam's constants as ``optax.adam`` sets them
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: the steps whose enqueue a traced fit times one by one: on an H100 the
#: launch queue holds ~16 of the wide fit's steps (~63 launches each), so
#: the first 8 never wait on the card and their spans time the host alone
HEAD_STEPS = 8


class FitPhases:
    """The spans of one fit (``fit`` and its phases) on ``recorder``, each
    one a ``record_function`` range too, all sharing the recorder's next
    id as ``meta["fit"]``. ``on`` is false where there is neither a
    recorder nor a profiler; then nothing is recorded."""

    def __init__(self, recorder: SpanRecorder | None = None, profiling: bool = False):
        self.recorder = recorder
        self.on = profiling or recorder is not None
        self.fit = recorder.next_id() if recorder is not None else None

    @classmethod
    def current(cls) -> "FitPhases":
        """This context's: the recorder :func:`recording` installed, and
        ranges where a profiler is active."""
        return cls(current_recorder(), torch.autograd._profiler_enabled())

    @contextlib.contextmanager
    def root(self):
        """The ``fit`` span around a whole fit; inside it, :func:`_fit_phases`
        is this fit's. Yields the span's meta, as :meth:`span` does."""
        if not self.on:
            yield {}
            return
        token = _FIT.set(self)
        try:
            with self.span("fit", None) as meta:
                yield meta
        finally:
            _FIT.reset(token)

    @contextlib.contextmanager
    def span(self, name: str, parent: str | None = "fit", **meta):
        """Time the block as span ``name`` under ``parent``; yields the
        span's meta, which the block may fill with counts it learns."""
        if not self.on:
            yield meta
            return
        rec = self.recorder
        with annotate(name):
            if rec is None:  # a profiler alone: the range, no span
                yield meta
                return
            start = rec.now()
            try:
                yield meta
            finally:
                rec.add(name, CATEGORY_FIT, start, rec.now() - start, parent=parent,
                        fit=self.fit, **meta)


#: the phases of the fit in progress in this context (set by ``FitPhases.root``)
_FIT: contextvars.ContextVar[FitPhases | None] = contextvars.ContextVar(
    "bodywork_tpu_torch_fit_phases", default=None)
_UNTRACED = FitPhases()


def _fit_phases() -> FitPhases:
    """The phases of the fit in progress here; outside a traced fit, ones
    that record nothing (``train_core`` called on its own)."""
    return _FIT.get() or _UNTRACED


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
        # fitted or loaded parameters: no autograd graph on the request
        # path (training differentiates its own copies, ``train_core``)
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


def init_mlp_params(key: torch.Tensor, sizes: tuple[int, ...], device=None) -> dict:
    """He-initialised dense stack; sizes = (in, *hidden, out). The JAX
    ``init_mlp_params`` (``mlp.py:49-56``) on a threefry key: one key per
    layer from ``split(key, L)``, a standard normal ``(fan_in, fan_out)``
    draw (row-major, as ``jax.random.normal`` counts) times
    ``sqrt(2 / fan_in)`` rounded to float32, on ``device``."""
    keys = prng.split(key.to(device), len(sizes) - 1)
    layers = []
    for k, (fan_in, fan_out) in zip(keys, zip(sizes[:-1], sizes[1:])):
        scale = float(np.sqrt(np.float32(2.0 / fan_in)))  # float32, as jnp.sqrt forms it
        w = prng.normal(k, fan_in * fan_out).reshape(fan_in, fan_out) * scale
        layers.append({"w": w, "b": torch.zeros((fan_out,), device=device)})
    return {"layers": layers}


def mlp_forward(net_params: dict, x: torch.Tensor,
                compute_dtype: str | None = None) -> torch.Tensor:
    """Dense->relu stack; returns (n,) float32 predictions in standardised
    space. ``compute_dtype="bfloat16"`` casts every matmul operand
    (activations, weights, biases) to bf16; autograd then runs the
    backward products in bf16 too and hands f32 gradients to the f32
    params."""
    layers = net_params["layers"]
    dtype = getattr(torch, compute_dtype) if compute_dtype else None
    cast = (lambda a: a.to(dtype)) if dtype else (lambda a: a)
    h = cast(x)
    for layer in layers[:-1]:
        h = torch.relu(h @ cast(layer["w"]) + cast(layer["b"]))
    out = h @ cast(layers[-1]["w"]) + cast(layers[-1]["b"])
    return out[:, 0].to(torch.float32)


def mlp_apply(params: dict, x: torch.Tensor, compute_dtype: str | None = None) -> torch.Tensor:
    """Full apply incl. the folded-in scaler: raw X -> raw prediction (the
    ``torch`` serving engine; the JAX ``xla`` engine). ``compute_dtype=
    "bfloat16"`` runs the dense stack in bf16, activations and biases
    included (the ``torch-bf16`` engine); the scaler arithmetic and the
    output stay float32 either way."""
    s = params["scaler"]
    h = (x - s["x_mean"]) / s["x_std"]
    out = mlp_forward(params["net"], h, compute_dtype)
    return out * s["y_std"] + s["y_mean"]


def _masked_stats(v: torch.Tensor, w: torch.Tensor):
    """Weighted mean and std (std floored at 1e-6) over the rows of ``v``
    ((n,) or (n, d)) with weight 1 — the scaler statistics
    (``mlp.py:155-160``, per column)."""
    wv = w if v.ndim == 1 else w[:, None]
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(v * wv, dim=0) / n
    var = torch.sum(wv * (v - mean) ** 2, dim=0) / n
    return mean, torch.clamp(torch.sqrt(var), min=1e-6)


def _scaled_splits(Xp: torch.Tensor, yp: torch.Tensor, w: torch.Tensor):
    """Masked standardisation stats + standardised train arrays
    (``mlp.py:98-105``)."""
    x_mean, x_std = _masked_stats(Xp, w)
    y_mean, y_std = _masked_stats(yp, w)
    Xs = (Xp - x_mean) / x_std
    ys = (yp - y_mean) / y_std
    scaler = {"x_mean": x_mean, "x_std": x_std, "y_mean": y_mean, "y_std": y_std}
    return Xs, ys, scaler


def _train_forward(net_params: dict, x: torch.Tensor, tc_layers: tuple) -> torch.Tensor:
    """:func:`mlp_forward` in float32 as a training step runs it when some
    layer's weight gradient takes the tensor-core kernel: each layer
    flagged in ``tc_layers`` is
    :func:`~bodywork_tpu_torch.ops.train_gemm.train_product` (on the CPU
    ``h @ w`` bit for bit), every other ``h @ w``."""
    layers = net_params["layers"]

    def dense(h, layer, tc):
        return (train_product(h, layer["w"]) if tc else h @ layer["w"]) + layer["b"]

    h = x
    for layer, tc in zip(layers[:-1], tc_layers):
        h = torch.relu(dense(h, layer, tc))
    return dense(h, layers[-1], tc_layers[-1])[:, 0]


def _tc_products(cfg: "MLPConfig", d_in: int, device: torch.device) -> int:
    """The products of one of ``cfg``'s training steps that take the
    tensor-core kernel on ``device`` (the ``fit`` span's ``tc_products``)."""
    return step_products((d_in, *cfg.hidden, 1), cfg.batch_size, device.type,
                         cfg.compute_dtype)


def _loss(net_params: dict, xb, yb, wb, compute_dtype: str | None = None,
          tc_layers: tuple = ()) -> torch.Tensor:
    """Weighted MSE over a minibatch, divided by max(sum(wb), 1). With a
    layer flagged in ``tc_layers``
    (:func:`~bodywork_tpu_torch.ops.train_gemm.kernel_layers`) the
    forward is :func:`_train_forward`, else :func:`mlp_forward`."""
    pred = (_train_forward(net_params, xb, tc_layers) if any(tc_layers)
            else mlp_forward(net_params, xb, compute_dtype))
    return torch.sum(wb * (pred - yb) ** 2) / torch.clamp(torch.sum(wb), min=1.0)


def draw_indices(key: torch.Tensor, n_steps: int, batch_size: int,
                 n_rows: int, device=None) -> torch.Tensor:
    """The training loop's minibatch index stream, ``(n_steps,
    batch_size)`` over ``[0, n_rows)`` — ``n_rows`` the PADDED row count —
    bit for bit what the JAX loop's scan draws from the train key ``key``
    (``mlp.py:112-120``: ``key, k_idx = split(key)``, then ``randint``
    each step). The key chain is walked on the host; every step's
    ``k_idx`` and indices are hashed at once on ``device``."""
    chain = prng.key_chain(key.cpu(), n_steps).to(device)
    return prng.randint(prng.split(chain)[:, 1], batch_size, 0, n_rows)


def _adam_update(params, grads, mu, nu, count: int, lr: float) -> None:
    """One in-place ``optax.adam(lr)`` step over lists of tensors:
    ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g²``, then
    ``p -= lr · mû / (sqrt(nû) + eps)`` with bias-corrected moments."""
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - ADAM_B1))
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - ADAM_B2))
    mu_hat = torch._foreach_div(mu, 1.0 - ADAM_B1**count)
    denom = torch._foreach_div(nu, 1.0 - ADAM_B2**count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    torch._foreach_div_(mu_hat, denom)
    torch._foreach_mul_(mu_hat, -lr)
    torch._foreach_add_(params, mu_hat)


def train_core(net_params: dict, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               idx: torch.Tensor, cfg: "MLPConfig"):
    """The minibatch Adam loop (``mlp.py:108-130``): one step per row of
    ``idx``, on fresh copies of ``net_params`` (which stay untouched).
    Returns ``(trained net params, per-step losses)``, every tensor on
    the data's device and detached; nothing is fetched to the host.
    Inside a traced fit the loop is its ``fit.dispatch`` span and the first
    :data:`HEAD_STEPS` steps are ``fit.step`` spans (``meta["step"]`` the
    step's count, 1-based)."""
    layers = net_params["layers"]
    params = [t.detach().clone().requires_grad_(True)
              for layer in layers for t in (layer["w"], layer["b"])]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    net = {"layers": [{"w": params[2 * i], "b": params[2 * i + 1]}
                      for i in range(len(layers))]}
    n_steps = idx.shape[0]
    losses = torch.empty(n_steps, device=X.device)
    tc_layers = kernel_layers([tuple(layer["w"].shape) for layer in layers], idx.shape[1],
                              X.device.type, cfg.compute_dtype)

    def run_step(step: int) -> None:
        i = idx[step]
        loss = _loss(net, X[i], y[i], w[i], cfg.compute_dtype, tc_layers)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            _adam_update(params, list(grads), mu, nu, step + 1, cfg.learning_rate)
            losses[step] = loss

    phases = _fit_phases()
    with phases.span("fit.dispatch", steps=n_steps):
        head = phases.on
        for step in range(n_steps):
            if head and step < HEAD_STEPS:
                with phases.span("fit.step", "fit.dispatch", step=step + 1):
                    run_step(step)
            else:
                run_step(step)
    trained = {"layers": [{"w": layer["w"].detach(), "b": layer["b"].detach()}
                          for layer in net["layers"]]}
    return trained, losses


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


def fit_keys(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(k_init, k_train)``: ``split(PRNGKey(seed))``, as the JAX ``fit``
    and ``fit_and_evaluate`` derive them (``mlp.py:177-185,212``)."""
    k_init, k_train = prng.split(prng.PRNGKey(seed))
    return k_init, k_train


class MLPRegressor(Regressor):
    model_type = "mlp"
    apply = staticmethod(mlp_apply)

    def __init__(self, config: MLPConfig | None = None, params: dict | None = None):
        super().__init__(config or MLPConfig())
        self.net = None if params is None else MLPNet(params["net"]["layers"])
        self.scaler = None if params is None else dict(params["scaler"])
        #: the training loss at the last optimisation step (set by fit)
        self.final_loss: float | None = None

    @property
    def params(self) -> dict | None:
        if self.net is None:
            return None
        return {"net": self.net.params(), "scaler": self.scaler}

    @property
    def device(self) -> torch.device:
        return self.net.layers[0].w.device

    def _train(self, seed: int | None, Xp, yp, w):
        """Scaler, He init and the Adam loop over padded device arrays,
        with the JAX fit's draws for ``seed`` (the config's when None);
        returns (params, losses)."""
        cfg = self.config
        phases = _fit_phases()
        with phases.span("fit.init"):
            k_init, k_train = fit_keys(cfg.seed if seed is None else seed)
            Xs, ys, scaler = _scaled_splits(Xp, yp, w)
            net = init_mlp_params(k_init, (Xp.shape[1],) + cfg.hidden + (1,), device=Xp.device)
        with phases.span("fit.indices", steps=cfg.n_steps):
            idx = draw_indices(k_train, cfg.n_steps, cfg.batch_size, Xp.shape[0],
                               device=Xp.device)
        net, losses = train_core(net, Xs, ys, w, idx, cfg)
        return {"net": net, "scaler": scaler}, losses

    def fit(self, X, y, seed: int | None = None, device=None) -> "MLPRegressor":
        phases = FitPhases.current()
        with phases.root() as meta:
            with phases.span("fit.prepare"):
                dev = resolve_device(device)
                require_ieee_f32_matmul(dev)
                X, y = as_rows(X, y)
                Xp, yp, w = (torch.as_tensor(a, device=dev) for a in pad_rows(X, y))
            meta.update(rows=X.shape[0], padded_rows=Xp.shape[0],
                        batch=self.config.batch_size, steps=self.config.n_steps,
                        tc_products=_tc_products(self.config, Xp.shape[1], dev))
            params, losses = self._train(seed, Xp, yp, w)
            with phases.span("fit.drain"):
                final_loss = float(losses[-1])
            fitted = MLPRegressor(self.config, params)
            fitted.final_loss = final_loss
        return fitted

    def fit_and_evaluate(self, X_train, y_train, X_test, y_test,
                         seed: int | None = None, device=None):
        """Scaler + init + Adam loop + held-out metrics on the device; the
        metrics and the final loss come back in one transfer."""
        from bodywork_tpu_torch.models.metrics import _metrics, metrics_dict

        phases = FitPhases.current()
        with phases.root() as meta:
            with phases.span("fit.prepare"):
                dev = resolve_device(device)
                require_ieee_f32_matmul(dev)
                Xp, yp, w, Xe, ye, we = (
                    torch.as_tensor(a, device=dev)
                    for a in self._pad_splits(X_train, y_train, X_test, y_test)
                )
            meta.update(rows=len(X_train), padded_rows=Xp.shape[0],
                        batch=self.config.batch_size, steps=self.config.n_steps,
                        tc_products=_tc_products(self.config, Xp.shape[1], dev))
            params, losses = self._train(seed, Xp, yp, w)
            with phases.span("fit.drain"):
                with torch.no_grad():
                    m = _metrics(ye, mlp_apply(params, Xe), we)
                tail = torch.stack([*m, losses[-1]]).tolist()
            fitted = MLPRegressor(self.config, params)
            fitted.final_loss = tail[3]
        return fitted, metrics_dict(tail)

    def fine_tune(self, X, y, n_steps: int, seed: int | None = None) -> "MLPRegressor":
        """Warm-started continuation (``mlp.py:222-258``): resume training
        from THIS model's params for ``n_steps`` on (X, y), on its device.
        The donor's scaler is KEPT, so predictions stay continuous with
        the donor's, and the optimizer state restarts fresh (checkpoints
        hold params only). The index stream is the JAX ``fine_tune``'s:
        the scan's chain straight from ``PRNGKey(seed)``, no init split.
        The tuned model carries the original config."""
        if self.net is None:
            raise ValueError("cannot fine-tune an unfitted model")
        cfg = dataclasses.replace(self.config, n_steps=n_steps)
        phases = FitPhases.current()
        with phases.root() as meta:
            with phases.span("fit.prepare"):
                dev = self.device
                require_ieee_f32_matmul(dev)
                X, y = as_rows(X, y)
                Xp, yp, w = pad_rows(X, y)
                s = params_to_host(self.scaler)
                # standardise with the DONOR's scaler, on the host; the padding
                # rows stay harmless (weight 0 in the loss)
                Xs = torch.as_tensor((Xp - s["x_mean"]) / s["x_std"], device=dev)
                ys = torch.as_tensor((yp - s["y_mean"]) / s["y_std"], device=dev)
                w = torch.as_tensor(w, device=dev)
            meta.update(rows=X.shape[0], padded_rows=Xp.shape[0], batch=cfg.batch_size,
                        steps=n_steps, tc_products=_tc_products(cfg, Xp.shape[1], dev))
            with phases.span("fit.indices", steps=n_steps):
                key = prng.PRNGKey(self.config.seed if seed is None else seed)
                idx = draw_indices(key, n_steps, cfg.batch_size, Xp.shape[0], device=dev)
            net, losses = train_core(self.net.params(), Xs, ys, w, idx, cfg)
            with phases.span("fit.drain"):
                final_loss = float(losses[-1])
            tuned = MLPRegressor(self.config, {"net": net, "scaler": dict(self.scaler)})
            tuned.final_loss = final_loss
        return tuned

    @property
    def n_features(self) -> int | None:
        return None if self.net is None else int(self.net.layers[0].w.shape[0])

    @property
    def info(self) -> str:
        return f"MLPRegressor(hidden={list(self.config.hidden)})"

    @classmethod
    def from_config_dict(cls, cfg: dict, params) -> "MLPRegressor":
        cfg = dict(cfg)
        cfg["hidden"] = tuple(cfg.get("hidden", (64, 64)))
        return cls(MLPConfig(**cfg), params)
