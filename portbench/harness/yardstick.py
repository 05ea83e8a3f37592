"""The benchmark's yardstick: the card's published peaks, the operations
and bytes of the MLP's kernels and training step, percentiles, and the
reduction of a device trace to busy time.

``peaks``, ``f32_product_ms`` and ``bound`` are copies of
``chip_smoke.py``'s, with the layer widths as an argument;
``wide_train_flops_per_step`` is a copy of ``bench.py``'s.
"""
from __future__ import annotations

import math


def peaks(name: str) -> dict:
    """Published dense peaks of the card (NVIDIA data sheets): f32 on the
    CUDA cores, TF32 and bf16 on the tensor cores (PCIe and NVL: half the
    sheet's with-sparsity figure), and the memory rate."""
    if "PCIe" in name:
        return {"part": "H100 PCIe", "f32": 51e12, "tf32": 378e12, "bf16": 756e12,
                "bytes_s": 2.0e12}
    if "NVL" in name:
        return {"part": "H100 NVL", "f32": 60e12, "tf32": 417.5e12, "bf16": 835e12,
                "bytes_s": 3.9e12}
    return {"part": "H100 SXM", "f32": 67e12, "tf32": 495e12, "bf16": 989e12,
            "bytes_s": 3.35e12}


def f32_accurate_peak(card: dict) -> float:
    """FLOP/s of f32-accurate products: the faster of FFMA on the CUDA
    cores and 3xTF32 (three TF32 products a multiply-add) on the tensor
    cores; 165 TFLOP/s on the SXM part."""
    return max(card["f32"], card["tf32"] / 3)


def forward_macs(rows: int, widths: tuple) -> int:
    """Multiply-adds of one forward of ``rows`` rows through a dense stack
    of ``widths`` (input, hidden..., output)."""
    return rows * sum(k * n for k, n in zip(widths[:-1], widths[1:]))


def f32_product_ms(rows: int, widths: tuple, card: dict) -> dict:
    """The two ways to run f32-accurate products on the card, in ms for
    one forward of ``rows`` rows: FFMA on the CUDA cores (2 operations a
    MAC at the f32 peak) and 3xTF32 on the tensor cores (three TF32
    products a MAC, 2 operations each, at the dense TF32 peak)."""
    macs = forward_macs(rows, widths)
    return {"ffma_ms": 1e3 * 2 * macs / card["f32"],
            "tf32x3_ms": 1e3 * 3 * 2 * macs / card["tf32"]}


def bound(rows: int, widths: tuple, engine: str, card: dict) -> tuple[float, str]:
    """The least time the card could take for one forward of ``rows``
    rows: the larger of its bytes (X read once, weights/biases/scales read
    once, the head written once) over the memory rate, and its operations
    over the peak rate for the operands' type. The f32 and int8 kernels
    need f32-accurate products: the faster of FFMA and 3xTF32; the bf16
    operands' peak is the tensor cores'."""
    pairs = list(zip(widths[:-1], widths[1:]))
    macs = forward_macs(rows, widths)
    weight_bytes = {"kernel": 4, "kernel-bf16": 2, "kernel-int8": 1}[engine]
    nbytes = (
        rows * widths[0] * 4 + sum(k * n for k, n in pairs) * weight_bytes
        + sum(n for _, n in pairs) * 4 * (2 if engine == "kernel-int8" else 1)
        + rows * 4
    )
    if engine == "kernel-bf16":
        t_ops = 2 * macs / card["bf16"]
    else:
        t_ops = 1e-3 * min(f32_product_ms(rows, widths, card).values())
    t_bytes = nbytes / card["bytes_s"]
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def wide_train_flops_per_step(batch: int, d_in: int, hidden: tuple) -> float:
    """Matmul FLOPs of one optimisation step of the MLP: forward
    2*b*sum(in_i*out_i) over the dense stack, backward ~2x forward (dL/dW
    and dL/dx matmuls), so ~3x forward per step. Elementwise/optimizer
    FLOPs are noise next to the matmuls and are ignored."""
    widths = (d_in, *hidden, 1)
    fwd = sum(2.0 * batch * a * b for a, b in zip(widths[:-1], widths[1:]))
    return 3.0 * fwd


def train_gemm_flops_per_step(batch: int, d_in: int, hidden: tuple) -> float:
    """FLOPs of the products one step computes: each layer's forward and
    weight gradient, and every layer's input gradient but the first's
    (the data needs none)."""
    widths = (d_in, *hidden, 1)
    per_layer = [2.0 * batch * a * b for a, b in zip(widths[:-1], widths[1:])]
    return 2 * sum(per_layer) + sum(per_layer[1:])


def train_gemm_bound_s(batch: int, d_in: int, hidden: tuple, card: dict) -> float:
    """The least time the card could take for one step's products
    (:func:`train_gemm_flops_per_step`'s): each product's operations at
    the f32-accurate peak or its bytes (both operands read once, the
    result written once) at the memory rate, whichever is longer."""
    widths = (d_in, *hidden, 1)
    peak = f32_accurate_peak(card)
    total = 0.0
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        t_ops = 2.0 * batch * a * b / peak
        t_bytes = 4.0 * (batch * a + a * b + batch * b) / card["bytes_s"]
        total += (2 if i == 0 else 3) * max(t_ops, t_bytes)
    return total


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    the order statistics; an infinite value (a request that failed)
    sorts last."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return xs[hi] if pos > lo else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` covered by the union of ``(start, end)``
    intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float, top: int = 10) -> list:
    """The ``top`` longest gaps in ``[lo, hi]`` between the union of
    ``(start, end)`` intervals: ``[(start, seconds)]``, longest first."""
    gaps, edge = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > edge:
            gaps.append((edge, s - edge))
        edge = max(edge, e)
    if hi > edge:
        gaps.append((edge, hi - edge))
    return sorted(gaps, key=lambda g: -g[1])[:top]
