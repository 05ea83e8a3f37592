"""The whole step's share of the card's f32-accurate peak: the forward
FLOPs of the rows the requests asked for (not the bucket's padding),
answered correctly in the window, over the window times the peak."""


def read(layer):
    if layer.get("kind") != "serve" or not layer.get("rows_ok"):
        return None
    flops = 2.0 * layer["macs_per_row"] * layer["rows_ok"]
    return 100.0 * flops / (layer["window_s"] * layer["peak_flops"])
