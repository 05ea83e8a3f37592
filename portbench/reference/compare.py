"""The numbers that decide ``correct``, each read against the plain
reference (``reference.mlp``) and held to a limit of the configuration's
file (``limits``)."""
from __future__ import annotations

import statistics

import numpy as np


def answer_gap(pred: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap of one answer's predictions from the reference's,
    over the answer's largest reference magnitude (at least 1)."""
    pred = np.asarray(pred, np.float64)
    ref = np.asarray(ref, np.float64)
    if pred.shape != ref.shape:
        return float("inf")
    return float(np.max(np.abs(pred - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def loss_gap(losses: list, ref_losses: list) -> float:
    """The widest relative gap between the program's and the reference's
    loss over the steps compared."""
    return max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))


def counted_leaves(grad_norms: list) -> list:
    """The leaves whose change is compared: those whose first gradient in
    the reference is at least a thousandth of the median leaf's (a leaf
    with none moves under Adam by round-off alone)."""
    floor = 1e-3 * statistics.median(grad_norms)
    return [i for i, g in enumerate(grad_norms) if g >= floor]


def change_gap(params: list, ref_params: list, init: list, leaves: list) -> float:
    """By the worst leaf: the gap between the norm of the program's change
    of a leaf from the initial weights and the reference's, over the
    reference's norm of that leaf's change or the median leaf's, whichever
    is larger."""
    prog = [float((p.double() - p0.double()).norm()) for p, p0 in zip(params, init)]
    ref = [float((p.double() - p0.double()).norm()) for p, p0 in zip(ref_params, init)]
    median = statistics.median(ref[i] for i in leaves)
    return max(abs(prog[i] - ref[i]) / max(ref[i], median) for i in leaves)
