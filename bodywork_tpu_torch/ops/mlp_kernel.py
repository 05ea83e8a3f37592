"""The fused MLP scoring forward: a hand-written CUDA kernel for Hopper and
its plain PyTorch version (the port of ``bodywork_tpu.ops.mlp_kernel``).

The serving hot path is standardise -> dense/relu stack -> unstandardise.
:func:`fold_scaler_into_net` folds the scaler into the first and last
layers once per model, so the kernel is a pure dense stack:

    W1' = W1 / x_std[:, None],   b1' = b1 - (x_mean / x_std) @ W1
    WL' = WL * y_std,            bL' = bL * y_std + y_mean

:func:`make_kernel_mlp_apply` builds ``apply(X) -> y`` over the folded
layers in one of three weight types — f32 (engine ``kernel``), bf16
(``kernel-bf16``) and symmetric per-output-column int8 (``kernel-int8``),
the counterparts of the Pallas ``pallas``, ``pallas-bf16`` and
``pallas-int8`` engines. For a CUDA tensor ``apply`` launches the kernel
in ``ops/csrc/mlp_kernel.cu`` (see its header for the design and the
bound) or raises; only a tensor on the CPU takes the plain version,
:func:`mlp_stack_plain`, which computes the same function in plain torch
ops — that is how the CPU tests run, and what ``chip_smoke.py`` holds the
kernel against on the card.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from bodywork_tpu_torch.device import resolve_device

#: the default serving bucket row tile (the Pallas ``ROW_TILE``): the
#: kernel predictor's buckets are (tile, 2*tile, 16*tile)
ROW_TILE = 256

#: compute dtype -> serving engine name of its kernel
KERNEL_ENGINES = {None: "kernel", "bfloat16": "kernel-bf16", "int8": "kernel-int8"}

_ENTRY_POINTS = {
    "kernel": "mlp_forward_f32",
    "kernel-bf16": "mlp_forward_bf16",
    "kernel-int8": "mlp_forward_int8",
}

#: launches of each kernel variant since the last :func:`reset_launches`;
#: each wrapper adds one where it launches its kernel, and nowhere else
LAUNCHES = {name: 0 for name in _ENTRY_POINTS}
_LAUNCH_LOCK = threading.Lock()

#: the C entry points take at most MAX_LAYERS layers
MAX_LAYERS = 16
#: rows of the batch one CUDA block owns (the kernel's template instances)
BLOCK_ROWS = (8, 16, 32)
#: output columns one pass of a block covers (MLP_COLS * MLP_THREADS in the
#: source): a stack whose layers are all at most this wide keeps its
#: activations in ONE shared-memory buffer, updated in place
COLUMNS_PER_PASS = 1024


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def fold_scaler_into_net(params: dict) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Fold the standardisation scaler into the dense stack's first and
    last layers; returns [(W, b), ...] equivalent to ``mlp_apply``."""
    s = params["scaler"]
    layers = [(layer["w"], layer["b"]) for layer in params["net"]["layers"]]
    w1, b1 = layers[0]
    inv = 1.0 / s["x_std"]
    layers[0] = (w1 * inv[:, None], b1 - (s["x_mean"] * inv) @ w1)
    # for a single-layer net layers[-1] IS layers[0], so the y-fold below
    # composes with the x-fold above
    wl, bl = layers[-1]
    layers[-1] = (wl * s["y_std"], bl * s["y_std"] + s["y_mean"])
    return layers


def quantize_int8(w) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 quantization of a 2-D weight
    matrix (a copy of ``bodywork_tpu.models.fused.quantize_int8``):
    returns ``(q, scale)`` with ``w ≈ q * scale[None, :]``. An all-zero
    column gets scale 1.0 (q is zero anyway)."""
    w = np.asarray(w, dtype=np.float32)
    absmax = np.max(np.abs(w), axis=0)
    scale = np.where(absmax > 0.0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def prepare_layers(folded, compute_dtype: str | None = None) -> list[dict]:
    """Folded (W, b) pairs -> the kernel's layer list: ``w`` in the
    variant's storage type (f32, bf16, or int8 with an f32 ``scale`` per
    output column), ``b`` f32, every tensor contiguous."""
    if compute_dtype not in KERNEL_ENGINES:
        raise ValueError(
            f"unknown kernel compute_dtype {compute_dtype!r}; expected one "
            f"of {list(KERNEL_ENGINES)}"
        )
    layers = []
    for w, b in folded:
        layer = {"b": b.to(torch.float32).contiguous(), "scale": None}
        if compute_dtype == "int8":
            q, scale = quantize_int8(w.detach().cpu().numpy())
            layer["w"] = torch.from_numpy(q).to(w.device)
            layer["scale"] = torch.from_numpy(scale).to(w.device)
        elif compute_dtype == "bfloat16":
            layer["w"] = w.to(torch.bfloat16).contiguous()
        else:
            layer["w"] = w.to(torch.float32).contiguous()
        layers.append(layer)
    return layers


def mlp_stack_plain(layers: list[dict], X: torch.Tensor,
                    compute_dtype: str | None = None) -> torch.Tensor:
    """The kernel's function in plain torch ops: returns column 0 of the
    folded stack's output, (n,) float32. bf16 rounds each layer's input
    activation to bf16 and multiplies in f32 (a bf16 x bf16 product is
    exact in f32); int8 dequantizes ``q * scale`` before an f32 product."""
    h = X.to(torch.float32)
    for i, layer in enumerate(layers):
        if compute_dtype == "int8":
            w = layer["w"].to(torch.float32) * layer["scale"][None, :]
        else:
            w = layer["w"].to(torch.float32)
        if compute_dtype == "bfloat16":
            h = h.to(torch.bfloat16).to(torch.float32)
        h = h @ w + layer["b"]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[:, 0]


def activation_bytes(widths, block_rows: int) -> int:
    """Dynamic shared memory one block needs: its rows' activations at the
    widest layer, in one buffer when every layer's outputs come from one
    column pass, else two (ping-pong)."""
    buffers = 1 if max(widths[1:]) <= COLUMNS_PER_PASS else 2
    return buffers * block_rows * max(widths) * 4


class _KernelLaunch:
    """Launch plan for one prepared layer list on one CUDA device: the
    ctypes argument arrays (pointers into the layer tensors, which this
    object keeps alive) are built once, not per call."""

    def __init__(self, layers: list[dict], engine: str, block_rows: int | None):
        from bodywork_tpu_torch.ops._build import load_library

        device = layers[0]["w"].device
        widths = [layers[0]["w"].shape[0]] + [layer["w"].shape[1] for layer in layers]
        lib = load_library()
        budget = lib.mlp_max_dynamic_smem(device.index)
        if block_rows is not None and block_rows not in BLOCK_ROWS:
            raise ValueError(f"block_rows must be one of {BLOCK_ROWS}, got {block_rows}")
        self.fitting = [
            r for r in BLOCK_ROWS
            if activation_bytes(widths, r) <= budget and block_rows in (None, r)
        ]
        if not self.fitting:
            r = block_rows or BLOCK_ROWS[0]
            raise ValueError(
                f"layer widths up to {max(widths)} need {activation_bytes(widths, r)} "
                f"bytes of shared memory at {r} rows per block; the device allows {budget}"
            )
        self.layers = layers
        self.engine = engine
        self.device = device
        self._sms = torch.cuda.get_device_properties(device).multi_processor_count
        self._fn = getattr(lib, _ENTRY_POINTS[engine])
        self._error_string = lib.mlp_error_string
        n = len(layers)
        self._widths = (ctypes.c_int * (n + 1))(*widths)
        self._w = (ctypes.c_void_p * n)(*(layer["w"].data_ptr() for layer in layers))
        self._b = (ctypes.c_void_p * n)(*(layer["b"].data_ptr() for layer in layers))
        self._scale = (
            (ctypes.c_void_p * n)(*(layer["scale"].data_ptr() for layer in layers))
            if layers[0]["scale"] is not None else None
        )

    def block_rows(self, n_rows: int) -> int:
        """Rows per block for an ``n_rows`` batch: the most rows (each
        block re-reads every weight from L2 once) whose grid still gives
        at least 90% of the SMs a block; small batches take the fewest
        rows, to spread over more SMs."""
        for r in sorted(self.fitting, reverse=True):
            if -(-n_rows // r) >= 0.9 * self._sms:
                return r
        return min(self.fitting)

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        if X.device != self.device:
            raise ValueError(f"input on {X.device}, kernel weights on {self.device}")
        X = X.to(torch.float32).contiguous()
        n = X.shape[0]
        if n >= 2**31:
            raise ValueError(f"{n} rows exceed the kernel's 32-bit row count")
        out = torch.empty(n, dtype=torch.float32, device=X.device)
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = self._fn(
            X.data_ptr(), out.data_ptr(), n, len(self.layers), self._widths,
            self._w, self._b, self._scale, self.block_rows(n), stream,
        )
        if rc != 0:
            raise RuntimeError(
                f"{self.engine} kernel launch failed: "
                f"{self._error_string(rc).decode()} (cudaError {rc})"
            )
        with _LAUNCH_LOCK:
            LAUNCHES[self.engine] += 1
        return out


def make_kernel_mlp_apply(params: dict, device=None,
                          compute_dtype: str | None = None,
                          row_tile: int | None = None,
                          block_rows: int | None = None):
    """Build ``apply(X) -> y`` running the folded MLP through the fused
    kernel (on ``device``: the card unless asked for the CPU).

    ``apply`` takes (n, d) or (n,) input (numpy or torch), raises
    ``ValueError`` on a feature-count mismatch, and returns the (n,)
    regression head, unpadded, as a float32 tensor on ``device``. On a
    CUDA device it launches the kernel; on the CPU it runs
    :func:`mlp_stack_plain`.

    ``row_tile`` is the serving bucket's row tile (default
    :data:`ROW_TILE`, a positive multiple of 8, else ``ValueError``);
    the kernel predictor pads batches to its multiples. The kernel itself
    masks ragged rows and widths, so ``apply`` pads nothing.
    ``block_rows`` (8, 16 or 32) pins the rows each CUDA block owns; by
    default each launch picks them from its batch size
    (``_KernelLaunch.block_rows``).
    """
    tile = int(row_tile or ROW_TILE)
    if tile < 8 or tile % 8 != 0:
        raise ValueError(f"row_tile must be a positive multiple of 8, got {tile}")
    dev = resolve_device(device)
    engine = KERNEL_ENGINES.get(compute_dtype)
    layers = prepare_layers(
        fold_scaler_into_net(_params_on(params, dev)), compute_dtype
    )
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"the kernel takes at most {MAX_LAYERS} layers, got {len(layers)}")
    d_in = layers[0]["w"].shape[0]
    launch = _KernelLaunch(layers, engine, block_rows) if dev.type == "cuda" else None

    def apply(X) -> torch.Tensor:
        if isinstance(X, torch.Tensor) and X.device.type != dev.type:
            # never move a tensor to another kind of device behind the
            # caller's back: a CUDA tensor launches the kernel or raises
            raise ValueError(f"input on {X.device}, the kernel serves {dev}")
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        if X.ndim == 1:
            X = X[:, None]
        if X.shape[1] != d_in:
            # zero-filling a short row would silently score garbage; the
            # torch engine raises on a feature-count mismatch too
            raise ValueError(f"expected {d_in} feature(s), got {X.shape[1]}")
        if X.is_cuda:
            return launch(X)
        return mlp_stack_plain(layers, X, compute_dtype)

    apply.engine = engine
    apply.layers = layers
    apply.row_tile = tile
    apply.launch = launch
    return apply


def _params_on(params, device):
    if isinstance(params, dict):
        return {k: _params_on(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_params_on(v, device) for v in params]
    return params.detach().to(device=device, dtype=torch.float32)
