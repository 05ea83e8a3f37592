"""The plain reference of both configurations: a dense ReLU stack in
float32, its serving apply with the standardisation scaler folded in,
and the first steps of its minibatch Adam fit, written in plain torch
operations from the model's description. It imports nothing of
``bodywork_tpu_torch``.

The fit is the one the configuration states: He-normal init from the
fit seed's key, the scaler's masked mean and standard deviation (floored
at 1e-6) over the rows padded to a power of two of at least 1024 with
weight-0 rows, a ``(batch,)`` minibatch drawn by index each step, the
weighted MSE divided by ``max(sum(w), 1)``, and Adam as ``optax.adam(lr)``
sets it (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
bias-corrected). The seeded draws are :mod:`.threefry`'s.

Products run in IEEE float32 under ``precision(False)``, which turns
TF32 off for its duration; ``precision(True)`` turns it on, the
control's lower precision.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import threefry

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def precision(tf32: bool):
    """Products in TF32 (``tf32=True``, the control) or IEEE float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def forward(layers: list, x: torch.Tensor) -> torch.Tensor:
    """``(n, d)`` standardised rows -> ``(n,)`` outputs: ReLU after every
    layer but the last."""
    h = x
    for i, (w, b) in enumerate(layers):
        h = h @ w + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[:, 0]


def apply(layers: list, scaler: dict, x: torch.Tensor) -> torch.Tensor:
    """Raw rows -> raw predictions: standardise, forward, unstandardise."""
    h = (x - scaler["x_mean"]) / scaler["x_std"]
    return forward(layers, h) * scaler["y_std"] + scaler["y_mean"]


def init_layers(seed: int, sizes: tuple, device) -> list:
    """He-normal weights from the fit's init key (``split(PRNGKey(seed))``
    first, then one key a layer), zero biases."""
    k_init = threefry.split(threefry.prng_key(seed))[0]
    keys = threefry.split(k_init, len(sizes) - 1)
    layers = []
    for k, (fan_in, fan_out) in zip(keys, zip(sizes[:-1], sizes[1:])):
        scale = np.sqrt(np.float32(2.0 / fan_in)).astype(np.float32)
        w = threefry.normal(k, fan_in * fan_out).reshape(fan_in, fan_out) * scale
        layers.append((torch.from_numpy(w).to(device), torch.zeros(fan_out, device=device)))
    return layers


def minibatch_indices(seed: int, n_steps: int, batch: int, n_rows: int) -> np.ndarray:
    """The ``(n_steps, batch)`` row indices the fit draws from its train
    key over ``n_rows`` padded rows."""
    k_train = threefry.split(threefry.prng_key(seed))[1]
    subs = threefry.split(threefry.key_chain(k_train, n_steps))[:, 1]
    return threefry.randint(subs, batch, 0, n_rows)


def padded_rows(n: int, minimum: int = 1024) -> int:
    rows = minimum
    while rows < n:
        rows *= 2
    return rows


def _stats(v: torch.Tensor, w: torch.Tensor):
    wv = w if v.ndim == 1 else w[:, None]
    n = torch.clamp(w.sum(), min=1.0)
    mean = (v * wv).sum(0) / n
    std = torch.sqrt((wv * (v - mean) ** 2).sum(0) / n)
    return mean, torch.clamp(std, min=1e-6)


def fit_steps(X: np.ndarray, y: np.ndarray, seed: int, hidden: tuple, lr: float,
              batch: int, n_steps: int, device, keep: int | None = None,
              record: tuple = ()) -> dict:
    """The fit's first ``n_steps`` steps: ``losses`` (each step's, before
    its update), ``init`` (the starting layers), ``params`` (``{step:
    layers after that step}`` on the host, for each step of ``record``
    and the last), ``grad_norms`` (each leaf's first gradient norm) and
    the ``scaler``. Leaves are ordered ``w0, b0, w1, b1, ...``. ``keep``
    plants a fault for the controls: each step uses only the first
    ``keep`` rows of its minibatch."""
    n, d = X.shape
    rows = padded_rows(n)
    Xp = torch.zeros((rows, d), device=device)
    yp = torch.zeros(rows, device=device)
    w = torch.zeros(rows, device=device)
    Xp[:n] = torch.as_tensor(X.reshape(n, d), device=device)
    yp[:n] = torch.as_tensor(y, device=device)
    w[:n] = 1.0
    x_mean, x_std = _stats(Xp, w)
    y_mean, y_std = _stats(yp, w)
    Xs, ys = (Xp - x_mean) / x_std, (yp - y_mean) / y_std
    layers = init_layers(seed, (d, *hidden, 1), device)
    leaves = [t.clone().requires_grad_(True) for layer in layers for t in layer]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    idx = torch.as_tensor(minibatch_indices(seed, n_steps, batch, rows), device=device)
    losses = torch.empty(n_steps, device=device)
    out = {"losses": [], "params": {}, "grad_norms": None,
           "init": [t.detach().cpu() for layer in layers for t in layer],
           "scaler": {"x_mean": x_mean, "x_std": x_std, "y_mean": y_mean, "y_std": y_std}}
    for t in range(n_steps):
        i = idx[t] if keep is None else idx[t][:keep]
        pairs = [(leaves[2 * j], leaves[2 * j + 1]) for j in range(len(layers))]
        pred = forward(pairs, Xs[i])
        loss = (w[i] * (pred - ys[i]) ** 2).sum() / torch.clamp(w[i].sum(), min=1.0)
        grads = torch.autograd.grad(loss, leaves)
        if out["grad_norms"] is None:
            out["grad_norms"] = [float(g.norm()) for g in grads]
        with torch.no_grad():
            for p, g, mt, vt in zip(leaves, grads, m, v):
                mt.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
                vt.mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
                m_hat = mt / (1 - ADAM_B1 ** (t + 1))
                v_hat = vt / (1 - ADAM_B2 ** (t + 1))
                p.sub_(lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
        losses[t] = loss.detach()
        if t + 1 in record or t + 1 == n_steps:
            out["params"][t + 1] = [p.detach().cpu().clone() for p in leaves]
    out["losses"] = losses.tolist()
    return out
