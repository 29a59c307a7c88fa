"""The numbers that decide ``correct``: the program's readings against the
plain reference's, each compared with its limit from
``port_bench/limits/<cell>.json``. A norm is compared as a gap of norms
taken by the worst leaf, |‖p‖ - ‖r‖| / max(‖r‖, the median leaf's ‖r‖),
never as the norm of the difference.

Training (the first three steps of the object the window then drives):

* ``update_gap``: each trainable leaf's change over the three steps, the
  worst leaf. Leaves whose reference gradient is under a thousandth of
  the median leaf's (a conv bias ahead of a train-mode BatchNorm, whose
  gradient is nought to rounding) are left out: AdamW moves them by
  round-off alone.
* ``bn_gap``: each BatchNorm running statistic's change by the first
  step's commit, the worst one; ``bn_gap_median``: the median one.

Serving (whole runs of streams drawn from the seed):

* ``out_gap``: per served frame and sequence, ‖z_p - z_r‖ / max(‖z_r‖,
  the median one's ‖z_r‖), the worst one, where z = asinh(y / y_scale) is
  the served output taken back through the denormalization's exact
  inverse (the model's output up to the manifest's affine map).

Why these and not the others the training comparison reads (each
step's loss, the first gradient's norms), which separate no lower
precision from the program: PERF.md, section 4.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np

RULE_OUT = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms against max(its reference norm, the median
    leaf's); a missing or non-finite reading is an infinite gap."""
    if not keys:
        return {}
    med = statistics.median(ref[k] for k in keys)
    out = {}
    for k in keys:
        p = prog.get(k, math.nan)
        denom = max(ref[k], med)
        g = abs(p - ref[k]) / denom if denom > 0 else (0.0 if p == 0
                                                        else math.inf)
        out[k] = g if math.isfinite(g) else math.inf
    return out


def _gap(prog, ref, keys) -> float:
    return max(leaf_gaps(prog, ref, keys).values(), default=0.0)


def train_leaves(ref: dict):
    """(the reference's first gradients, the leaves kept by the rule)."""
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    return g_ref, [k for k in g_ref if g_ref[k] >= RULE_OUT * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses", "grad_norms", "change", "commit"}
    (the reference's ``train_steps`` result and the program's readings)."""
    g_ref, moved = train_leaves(ref)
    stats = sorted(ref["commit"])
    commit = prog.get("commit", {})
    return {"update_gap": _gap(prog["change"], ref["change"], moved),
            "bn_gap": _gap(commit, ref["commit"], stats),
            "bn_gap_median": _median_gap(commit, ref["commit"], stats)}


def _median_gap(prog, ref, keys) -> float:
    gaps = leaf_gaps(prog, ref, keys)
    return statistics.median(gaps.values()) if gaps else 0.0


def train_worst(prog: dict, ref: dict, top: int = 3) -> Dict[str, list]:
    """The ``top`` worst leaves of the first gradient's norms, the
    changes and the commit: [name, gap, program's norm, reference's norm]
    (for the look behind a reading)."""
    g_ref, moved = train_leaves(ref)
    out = {}
    for number, p, r, keys in (
            ("grad", prog.get("grad_norms", {}), g_ref, moved),
            ("update_gap", prog["change"], ref["change"], moved),
            ("bn_gap", prog.get("commit", {}), ref["commit"],
             sorted(ref["commit"]))):
        gaps = leaf_gaps(p, r, keys)
        out[number] = [[k, gaps[k], p.get(k), r[k]] for k in
                       sorted(gaps, key=lambda k: -gaps[k])[:top]]
    return out


def serve_numbers(prog: List[np.ndarray], ref: List[np.ndarray],
                  y_scale: float) -> Dict[str, float]:
    """Each a frame's [sequences, H, W] output in m/s, the program's and the
    reference's, in the same order. Both are compared in the model's own
    space, through asinh(y / y_scale): the denormalization's sinh would
    otherwise turn the model's small absolute errors into relative ones
    of any size."""
    if len(prog) != len(ref) or any(p is None for p in prog):
        return {"out_gap": math.inf}

    def model_space(y):
        return np.arcsinh(np.asarray(y, np.float64) / y_scale)

    diff = np.stack([np.sqrt(((model_space(p) - model_space(r)) ** 2)
                             .reshape(len(r), -1).sum(1))
                     for p, r in zip(prog, ref)])
    norm = np.stack([np.sqrt((model_space(r) ** 2)
                             .reshape(len(r), -1).sum(1)) for r in ref])
    gap = diff / np.maximum(norm, np.median(norm))
    return {"out_gap": float(gap.max()) if np.all(np.isfinite(gap))
            else math.inf}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): correct where every number
    has a limit and lies at or under it and every limit has its number. A
    cell with no limits file, a number without a limit or a limit without
    a number is not correct (a missing value or limit shows as None)."""
    checks = {name: {"value": numbers.get(name), "limit": limits.get(name)}
              for name in list(numbers) + [n for n in limits
                                           if n not in numbers]}
    ok = bool(checks) and all(
        c["value"] is not None and c["limit"] is not None
        and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
