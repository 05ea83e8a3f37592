"""Quantized inference weights (the port of the quantization half of
``bodywork_tpu.models.fused``; ``serve --dtype int8``).

Serving a small-to-mid MLP re-reads the whole dense stack every forward,
so int8 weights move a quarter of f32's bytes, at a relative error of
order 1/127 on each product's weight operand. The quantization is
symmetric per OUTPUT channel (one f32 scale per weight column), so each
column's grid follows its own range. Biases and the folded scaler stay
f32, and so does every accumulation. Whether the realised quality delta
may serve is decided by the shadow gate
(``serve.server.build_serving_predictor``), not here.

:func:`quantize_int8` is numpy, the JAX package's code line for line, so
both packages quantize a checkpoint to the same bytes; it is also what
the ``kernel-int8`` engine's weights are made from
(``ops.mlp_kernel.prepare_layers``).
"""
from __future__ import annotations

import numpy as np
import torch


def quantize_int8(w) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 quantization of a 2-D weight
    matrix: returns ``(q, scale)`` with ``w ≈ q * scale[None, :]``. An
    all-zero column gets scale 1.0 (q is zero anyway)."""
    w = np.asarray(w, dtype=np.float32)
    absmax = np.max(np.abs(w), axis=0)
    scale = np.where(absmax > 0.0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def quantize_mlp_params_int8(params: dict) -> dict:
    """An MLP's params with each dense weight quantized to int8 ``wq`` and
    its f32 ``w_scale`` per column; biases and the scaler ride through as
    float32. Quantized on the host, once; every tensor goes back to the
    device of the weights it came from, where :func:`int8_mlp_apply`
    serves it."""
    layers = []
    for layer in params["net"]["layers"]:
        dev = layer["w"].device
        q, scale = quantize_int8(_host(layer["w"]))
        layers.append({
            "wq": torch.from_numpy(q).to(dev),
            "w_scale": torch.from_numpy(scale).to(dev),
            "b": layer["b"].detach().to(torch.float32),
        })
    scaler = {k: v.detach().to(torch.float32) for k, v in params["scaler"].items()}
    return {"net": {"layers": layers}, "scaler": scaler}


def dequantize_mlp_params(qparams: dict) -> dict:
    """The f32 params an int8 tree represents (``wq * w_scale``), to bound
    the quantization error against the original."""
    layers = [{"w": layer["wq"].to(torch.float32) * layer["w_scale"][None, :],
               "b": layer["b"]} for layer in qparams["net"]["layers"]]
    return {"net": {"layers": layers}, "scaler": dict(qparams["scaler"])}


def int8_mlp_apply(qparams: dict, x: torch.Tensor) -> torch.Tensor:
    """Full MLP apply from int8 weights: raw X -> raw prediction. Each
    weight dequantizes to f32 (``wq * w_scale``) before an f32 product,
    as the JAX program does (``fused.py:120-135``)."""
    s = qparams["scaler"]
    h = (x - s["x_mean"]) / s["x_std"]
    layers = qparams["net"]["layers"]
    for i, layer in enumerate(layers):
        w = layer["wq"].to(torch.float32) * layer["w_scale"][None, :]
        h = h @ w + layer["b"]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[:, 0] * s["y_std"] + s["y_mean"]
