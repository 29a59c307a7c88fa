"""The model FLOPs of the requests answered in the traced window over the
sum of their service times (``predict``'s spans) times the card's bf16
peak."""

from port_bench import roofline as _roof


def read(view):
    if view.kind != "serve" or view.traced is None:
        return None
    times = view.spans.durations("predict", view.traced["t0"],
                                 view.traced["t1"])
    if not times:
        return None
    return 100.0 * len(times) * view.unit_flops / (
        sum(times) * _roof.BF16_OPS_PER_S)
