"""The serving knee, found once when a serving cell is defined: the cell
run at several offered rates in one process, each a short window.

    python3 -m port_bench.sweep --workload <cell> --rates 20,30,40 \
        [--seconds 8] [--seed 1]

Prints one JSON line a rate: the rate offered, the requests served in the
window and their rate, the latency p50 and p95, the median service time,
and the queueing delay (start after due) over the window's first and last
quarters: a delay that grows from the first to the last quarter is a
backlog, so the rate is above what the system sustains. The cell's
traffic then takes 4/5 of the highest sustained rate, as a number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from .run import environment


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    environment()
    from .harness import run_cell

    for rate in (float(r) for r in args.rates.split(",")):
        got = []
        r = run_cell(args.workload, args.seed, args.seconds, False,
                     overrides={"traffic": {"rate_rps": rate}}, ctx_out=got)
        ctx = got[0]
        t0, t1 = ctx.window
        starts = [a for n, a, _ in ctx.spans.items
                  if n == "predict" and t0 <= a < t1]
        delay = [a - (t0 + i / rate) for i, a in enumerate(starts)]
        q = max(1, len(delay) // 4)
        service = ctx.spans.durations("predict", t0, t1)
        print(json.dumps({
            "workload": args.workload, "rate_rps": rate,
            "served": ctx.units, "served_rps": ctx.units / (t1 - t0),
            "p50_ms": r["metrics"]["serve_latency_ms_p50"]["value"],
            "p95_ms": r["metrics"]["serve_latency_ms_p95"]["value"],
            "service_p50_ms": 1e3 * statistics.median(service),
            "delay_first_quarter_ms": 1e3 * statistics.fmean(delay[:q]),
            "delay_last_quarter_ms": 1e3 * statistics.fmean(delay[-q:]),
            "correct": r["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
