"""The window's model FLOPs (port_bench/roofline.py's count of one step,
times the steps completed) over the window's seconds times the card's
bf16 peak."""

from port_bench import roofline as _roof


def read(view):
    if view.kind != "train" or not view.units:
        return None
    t0, t1 = view.window
    return 100.0 * view.units * view.unit_flops / (
        (t1 - t0) * _roof.BF16_OPS_PER_S)
