"""The MLP trainer's float32 weight gradients on Hopper's tensor cores: a
hand-written CUDA kernel (``ops/csrc/train_gemm.cu``: three TF32 ``wgmma``
products a product, f32-accurate) under the trainer's autograd, and its
plain PyTorch version.

:func:`train_product` is ``h @ w`` in the training step
(:class:`TrainProduct`): the forward ``h @ w`` and the input gradient
``dY @ w.T`` stay ``torch.matmul``; the weight gradient ``h.T @ dY`` is
:func:`weight_grad`, the kernel for CUDA tensors and ``h.T @ dY`` (the
plain version) on the CPU. The trainer takes it for a dense layer where
:func:`engages` holds for the layer's weight gradient: (M, N, K) = (its
input width, its output width, the minibatch), CUDA float32 operands, M,
N and K each at least :data:`MIN_DIM`, K a multiple of :data:`TILE_K`
and M and N of 4. :func:`kernel_layers` decides it once a fit; every
other layer runs ``h @ w`` as ``mlp_forward`` does, and a fit with no
such layer runs ``mlp_forward`` itself. At config 6 (32 -> 1024 -> 1024
-> 1024 -> 1, batch 32768) the two 1024 x 1024 layers engage; the first
layer (M = 32) and the 1-wide head do not; the daily fit (hidden (64,
64), batch 256) engages none. :func:`step_products` counts a step's
engaged products from the same gate.

Why the weight gradient alone: the kernel is as accurate as cuBLAS's
FFMA SGEMM against float64 at the forward's and input gradient's shapes
too, but the benchmark's check of a fit (``portbench``, ``loss_gap``
after Adam's first three steps at lr 1e-2, limit 1e-5) admits no forward
product that rounds otherwise than cuBLAS does: on the H100,
float64-exact forward products read up to 2.1e-4 there (PERF.md §6).

A kernel product is two launches, three where K is split: dY split into
TF32 hi and lo parts in the kernel's tiled layout, transposed
(``train_gemm_split``), then the product (``train_gemm``), whose split-K
partial sums a third kernel reduces in a fixed order. :data:`LAUNCHES`
counts each kind. ``chip_smoke.py`` holds the kernel against the plain
version and float64 on the card.
"""
from __future__ import annotations

import functools
import math
import threading

import torch

#: the smallest M, N and K of a weight gradient that takes the kernel:
#: below it the layer stays on ``torch.matmul``
MIN_DIM = 1024
#: the kernel's output tile (TG_BM x TG_BN) and k-tile (TG_BK)
TILE_M, TILE_N, TILE_K = 128, 128, 32
#: the most K splits a product takes
MAX_SPLITS = 16

#: kernel launches since the last :func:`reset_launches`: dY's split
#: pass, the product, and the split-K reduction
LAUNCHES = {"split": 0, "product": 0, "reduce": 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def engages(m: int, n: int, k: int, device_type: str, dtype=torch.float32) -> bool:
    """Whether an (M, N, K) weight gradient of ``dtype`` operands on a
    ``device_type`` device takes the kernel."""
    return (device_type == "cuda" and dtype == torch.float32 and min(m, n, k) >= MIN_DIM
            and m % 4 == 0 and n % 4 == 0 and k % TILE_K == 0)


def kernel_layers(shapes, batch: int, device_type: str,
                  compute_dtype: str | None = None) -> tuple[bool, ...]:
    """For each dense layer of ``shapes`` ((input width, output width)
    each) in a training step at minibatch ``batch``: whether its weight
    gradient takes the kernel. A ``compute_dtype`` (bf16 training) takes
    none."""
    return tuple(compute_dtype is None and engages(k, n, batch, device_type)
                 for k, n in shapes)


def step_products(widths, batch: int, device_type: str, compute_dtype: str | None = None) -> int:
    """How many of one training step's products take the kernel: the
    weight gradients of the dense stack ``widths`` (input, hidden...,
    output) that :func:`kernel_layers` admits."""
    return sum(kernel_layers(zip(widths[:-1], widths[1:]), batch, device_type, compute_dtype))


def split_count(m: int, n: int, k: int, n_sms: int) -> int:
    """The K splits of a kernel product: 1 where its output tiles fill
    the card's SMs; else the count with the fewest k-tiles a CTA runs in
    all its waves, the fewest splits among equals."""
    tiles = math.ceil(m / TILE_M) * math.ceil(n / TILE_N)
    if tiles >= n_sms:
        return 1
    k_tiles = k // TILE_K
    return min(range(1, min(MAX_SPLITS, k_tiles) + 1),
               key=lambda s: (math.ceil(tiles * s / n_sms) * math.ceil(k_tiles / s), s))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library():
    from bodywork_tpu_torch.ops._build import load_library

    return load_library("train_gemm")


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.train_gemm_error_string(rc).decode()} (cudaError {rc})")


def _aligned(*tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("train_gemm needs 16-byte aligned operands")


def split_dy(dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's B operand of ``h.T @ dy`` for a CUDA float32 ``dy``
    (K, N): ``dy.T`` split into TF32 hi and lo parts, each (N padded to
    :data:`TILE_N`) x K floats in the kernel's tiled layout."""
    dy = dy.contiguous()
    _aligned(dy)
    k, n = dy.shape
    lib = _library()
    n_pad = math.ceil(n / TILE_N) * TILE_N
    hi = torch.empty(n_pad * k, dtype=torch.float32, device=dy.device)
    lo = torch.empty_like(hi)
    _check(lib, lib.train_gemm_split(dy.data_ptr(), k, n, hi.data_ptr(), lo.data_ptr(),
                                     torch.cuda.current_stream(dy.device).cuda_stream),
           "train_gemm_split")
    _count("split")
    return hi, lo


def kernel_weight_grad(h: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``h.T @ dy`` on the kernel, for CUDA float32 ``h`` (K, M) and ``dy``
    (K, N) whose (M, N, K) :func:`engages` admits; raises otherwise."""
    k, m = h.shape
    n = dy.shape[1]
    if (not engages(m, n, k, h.device.type, h.dtype) or dy.dtype != h.dtype
            or dy.shape[0] != k):
        raise ValueError(f"train_gemm does not take h {tuple(h.shape)} {h.dtype} and dY "
                         f"{tuple(dy.shape)} {dy.dtype} on {h.device}")
    h = h.contiguous()
    _aligned(h)
    b_hi, b_lo = split_dy(dy)
    splits = split_count(m, n, k, _sms(h.device.index or 0))
    c = torch.empty((m, n), dtype=torch.float32, device=h.device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=h.device) if splits > 1 else None
    lib = _library()
    _check(lib, lib.train_gemm(h.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(), c.data_ptr(),
                               None if ws is None else ws.data_ptr(), m, n, k, splits,
                               torch.cuda.current_stream(h.device).cuda_stream), "train_gemm")
    _count("product")
    if splits > 1:
        _count("reduce")
    return c


def weight_grad(h: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``h.T @ dy``, a dense layer's weight gradient: the kernel for CUDA
    tensors (:func:`kernel_weight_grad`), else ``h.T @ dy`` (the plain
    version)."""
    if h.device.type == "cuda":
        return kernel_weight_grad(h, dy)
    return h.t() @ dy


class TrainProduct(torch.autograd.Function):
    """``h @ w`` whose weight gradient ``h.T @ dY`` is
    :func:`weight_grad`; the forward and the input gradient ``dY @ w.T``
    are ``torch.matmul``. On the CPU bit for bit the autograd of
    ``h @ w``."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return h @ w

    @staticmethod
    def backward(ctx, grad):
        h, w = ctx.saved_tensors
        grad_h = grad @ w.t() if ctx.needs_input_grad[0] else None
        grad_w = weight_grad(h, grad) if ctx.needs_input_grad[1] else None
        return grad_h, grad_w


def train_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` in the training step (:class:`TrainProduct`)."""
    return TrainProduct.apply(h, w)
