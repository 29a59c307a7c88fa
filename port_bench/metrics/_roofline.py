"""Shared by the kernel roofline readers: a kernel's share of its bound in
the traced window, the sum of each launch's bound (port_bench/roofline.py,
from the cell's shapes) over the kernel's device time in the trace.

It reads nothing, and the metric is left out, where the kernel did not run
or where the port's launch counters advanced by other than the launches
the arithmetic counts (a change that adds, removes or merges launches
makes this share silent, never wrong); it says so on standard error."""

import sys

PATTERNS = {"k1": ("gate_update_vec_kernel", "gate_update_scalar_kernel",
                   "gate_update_bwd_kernel"),
            "k2": ("conv3x3_fused_",)}
COUNTERS = {"k1": ("gate_update", "gate_update_bwd"),
            "k2": ("conv3x3_fused",)}


def share(view, kernel):
    traced = view.traced
    if traced is None or not traced["units"]:
        return None
    n = traced["units"]
    want = {c: view.unit_counts[c] * n for c in COUNTERS[kernel]}
    got = {c: traced["launches"][c] for c in COUNTERS[kernel]}
    if not any(want.values()):
        return None
    if want != got:
        print(f"{kernel}_roofline: launches {got} in the traced window, "
              f"the arithmetic counts {want}: left out", file=sys.stderr)
        return None
    seconds, _ = traced["summary"].kernel_time(*PATTERNS[kernel])
    if seconds <= 0:
        return None
    bound = n * sum(l.bound_s for l in view.unit_launches
                    if l.kernel == kernel)
    return 100.0 * bound / seconds
