"""The whole step's share of the card's f32-accurate peak: ``bench.py``'s
FLOPs a step (3 x the forward's) times the window's steps, over the
window (its start to the last fit's end) times the peak."""


def read(layer):
    if layer.get("kind") != "train" or not layer.get("steps"):
        return None
    return 100.0 * layer["flops_per_step"] * layer["steps"] / (
        layer["window_s"] * layer["peak_flops"])
