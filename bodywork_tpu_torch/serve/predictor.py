"""Shape-bucketed prediction wrappers for serving (the port of
``bodywork_tpu.serve.predictor``).

Each request's row count is padded up to a fixed bucket, and oversized
requests are chunked through the largest bucket, so the device runs a
small, pre-warmable set of shapes whatever the traffic. The buckets are
the JAX package's, so the same requests pad to the same shapes in both:

- :class:`PaddedPredictor` (engine ``torch``): buckets
  ``(1, 8, 64, 512, 4096)`` over the model's plain float32 ``apply``
  (``mlp_apply`` or ``linear_apply``);
- :class:`BF16MLPPredictor` (engine ``torch-bf16``) and
  :class:`Int8MLPPredictor` (``torch-int8``): an MLP's plain apply with
  bf16 activations, weights and biases, or from int8 weights quantized
  once and kept on the device (the JAX ``xla-bf16`` / ``xla-int8``),
  on the same buckets;
- :class:`KernelMLPPredictor` (engines ``kernel``, ``kernel-bf16``,
  ``kernel-int8``): the fused CUDA kernel (``ops.mlp_kernel``) with the
  Pallas predictor's bucket policy ``(tile, 2·tile, 16·tile)``.

Each predictor names its serving ``dtype`` (:data:`SERVE_DTYPES`), which
``/healthz`` reports as ``serving_dtype``.

The JAX package's AOT executable cache has no counterpart here yet: torch
runs eagerly, and a CUDA-graph cache is a later ROADMAP item.
"""
from __future__ import annotations

import numpy as np
import torch

from bodywork_tpu_torch.device import fence, require_ieee_f32_matmul
from bodywork_tpu_torch.models.mlp import MLPRegressor, mlp_apply
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.predictor")

DEFAULT_BUCKETS = (1, 8, 64, 512, 4096)

#: the serving precisions (``serve --dtype``): a quantized one serves only
#: after the shadow quality gate admits it (``serve.server``)
SERVE_DTYPES = ("float32", "bfloat16", "int8")


class PaddedPredictor:
    """Bucket-padding predictor over the model's plain f32 apply (full
    IEEE float32 products: :func:`require_ieee_f32_matmul`).
    Subclasses override :meth:`_dispatch_padded` to change the engine
    while reusing the bucket/pad/chunk logic here."""

    #: the serving dtype tag (/healthz ``serving_dtype``)
    dtype = "float32"
    engine = "torch"

    def __init__(self, model, buckets: tuple[int, ...] = DEFAULT_BUCKETS):
        self.model = model
        self.buckets = tuple(sorted(buckets))
        self.device = model.device

    def _dispatch_padded(self, Xp: np.ndarray) -> torch.Tensor:
        """Run the model on an exactly-bucket-sized batch (asynchronously
        on a CUDA device: the result is a device tensor)."""
        X = torch.as_tensor(Xp, device=self.device)
        with torch.inference_mode():
            return self.model.apply(self.model.params, X)

    def _predict_padded(self, Xp: np.ndarray) -> np.ndarray:
        return self._dispatch_padded(Xp).cpu().numpy()

    def warmup(self) -> None:
        """Run every bucket once before taking traffic, then fence, so a
        device fault (or a kernel that fails to build or launch) surfaces
        at boot rather than on the first request."""
        n_features = self.model.n_features
        results = [
            self._dispatch_padded(np.zeros((b, n_features), dtype=np.float32))
            for b in self.buckets
        ]
        fence(results)
        log.info(f"warmed up predict buckets {self.buckets} (n_features={n_features})")

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float32)
        if X.ndim == 1:
            X = X[:, None]
        n = X.shape[0]
        max_bucket = self.buckets[-1]
        if n > max_bucket:
            # chunk through the largest bucket
            parts = [
                self.predict(X[i : i + max_bucket]) for i in range(0, n, max_bucket)
            ]
            return np.concatenate(parts)
        b = self._bucket_for(n)
        if b != n:
            Xp = np.zeros((b, X.shape[1]), dtype=np.float32)
            Xp[:n] = X
        else:
            Xp = X
        return self._predict_padded(Xp)[:n]


def _require_mlp(model, engine: str) -> None:
    if not isinstance(model, MLPRegressor):
        raise ValueError(f"engine {engine!r} serves MLP models; got {model.info}")


class BF16MLPPredictor(PaddedPredictor):
    """Serves an MLP with the dense stack in bfloat16, activations and
    biases included (``mlp_apply(..., compute_dtype="bfloat16")``; the JAX
    ``xla-bf16`` engine), unlike ``kernel-bf16``, which keeps f32
    activations. Predictions carry bf16's ~3 significant digits."""

    dtype = "bfloat16"
    engine = "torch-bf16"

    def __init__(self, model, buckets: tuple[int, ...] | None = None):
        _require_mlp(model, self.engine)
        super().__init__(model, buckets or DEFAULT_BUCKETS)

    def _dispatch_padded(self, Xp: np.ndarray) -> torch.Tensor:
        X = torch.as_tensor(Xp, device=self.device)
        with torch.inference_mode():
            return mlp_apply(self.model.params, X, compute_dtype="bfloat16")


class Int8MLPPredictor(PaddedPredictor):
    """Serves an MLP from int8 weights (the JAX ``xla-int8`` engine): each
    dense weight is quantized once, here, to symmetric per-column int8
    (``models.fused.quantize_mlp_params_int8``) and kept on the device;
    every forward dequantizes it before an IEEE f32 product."""

    dtype = "int8"
    engine = "torch-int8"

    def __init__(self, model, buckets: tuple[int, ...] | None = None):
        from bodywork_tpu_torch.models import fused

        _require_mlp(model, self.engine)
        require_ieee_f32_matmul(model.device)
        super().__init__(model, buckets or DEFAULT_BUCKETS)
        self._qparams = fused.quantize_mlp_params_int8(model.params)

    def _dispatch_padded(self, Xp: np.ndarray) -> torch.Tensor:
        from bodywork_tpu_torch.models.fused import int8_mlp_apply

        X = torch.as_tensor(Xp, device=self.device)
        with torch.inference_mode():
            return int8_mlp_apply(self._qparams, X)


class KernelMLPPredictor(PaddedPredictor):
    """Serves an MLP through the fused CUDA kernel
    (:mod:`bodywork_tpu_torch.ops.mlp_kernel`): scaler folded into the
    weights once, the whole forward one launch per padded batch. On a
    CPU-resident model the kernel's plain version runs instead (the CPU
    tests)."""

    def __init__(self, model, buckets: tuple[int, ...] | None = None,
                 compute_dtype: str | None = None):
        from bodywork_tpu_torch.ops.mlp_kernel import ROW_TILE, make_kernel_mlp_apply

        if not isinstance(model, MLPRegressor):
            raise ValueError(f"the fused kernel serves MLP models; got {model.info}")
        if buckets is None:
            # the Pallas predictor's policy: sub-tile buckets would only
            # duplicate programs there, and keeping it makes the same
            # requests pad to the same shapes in both packages
            buckets = (ROW_TILE, 2 * ROW_TILE, 16 * ROW_TILE)
        super().__init__(model, buckets)
        #: the kernel's ``apply`` (its ``layers`` are what the kernel reads)
        self.kernel = make_kernel_mlp_apply(
            model.params, self.device, compute_dtype=compute_dtype,
        )
        self.engine = self.kernel.engine
        if compute_dtype in ("bfloat16", "int8"):
            self.dtype = compute_dtype

    def _dispatch_padded(self, Xp: np.ndarray) -> torch.Tensor:
        return self.kernel(Xp)
