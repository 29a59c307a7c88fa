"""The readings that the limits of ``port_bench/limits/<cell>.json`` are set
from, on the card at the cell's own size, several seeds in one process:

    python3 -m port_bench.controls --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--seconds 3]

* the program: a run of the cell (set-up, a short window at the cell's
  load, the comparison), its numbers;
* the controls: the reference in the program's place with every
  convolution's input and weight rounded to float8 (e4m3, one scale a
  tensor), the nearest precision below the configuration's bf16, compared
  with the float32 reference; for a serving cell also the program's own
  int8 path (the predictor's model quantized as ``StreamingPredictor(
  int8=True)`` quantizes it: every conv on K8, dynamic scales);
* the faults of a training cell: half of each batch left out, the mean
  taken over the rest (planted in the program's step).

One JSON line a reading on standard output. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check
from .run import environment
from .manifest import Manifest


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale (its max |t| over 448);
    the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def int8(pred):
    """The program's own int8 serving path on a built predictor."""
    from unet_convlstm_tpu_torch.ops.quant import quantize_model

    pred.model, pred.int8 = quantize_model(pred.model), True
    return pred


def half_batch(step):
    """The fault: a step that leaves out half of the batch."""
    def broken(model, opt, x, y):
        return step(model, opt, x[: x.shape[0] // 2], y[: y.shape[0] // 2])
    return broken


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    environment()
    from .harness import run_cell

    seeds = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    man = Manifest()
    kind = man.traffic(man.workload(args.workload)["traffic"])["kind"]

    def emit(what, seed, numbers, extra=None):
        print(json.dumps({"workload": args.workload, "what": what,
                          "seed": seed, "numbers": numbers, **(extra or {})}),
              flush=True)

    def worst(got):
        if kind != "train":
            return {}
        prog, ref = got[0].readings
        return {"worst": check.train_worst(prog, ref),
                "losses": [prog["losses"], ref["losses"]]}

    for seed in seeds(args.seeds):
        got = []
        r = run_cell(args.workload, seed, args.seconds, False, ctx_out=got)
        emit("program", seed, {k: c["value"] for k, c in r["checks"].items()},
             {"metrics": {k: v["value"] for k, v in r["metrics"].items()},
              "memory_peak_bytes": r["device"]["memory_peak_bytes"],
              **worst(got)})
    for seed in seeds(args.control_seeds):
        got = []
        r = run_cell(args.workload, seed, args.seconds, False,
                     hooks={"control_quant": fp8}, ctx_out=got)
        emit("control_fp8", seed,
             {k: c["value"] for k, c in r["checks"].items()}, worst(got))
        if kind == "serve":
            r = run_cell(args.workload, seed, args.seconds, False,
                         hooks={"predictor": int8})
            emit("control_int8", seed,
                 {k: c["value"] for k, c in r["checks"].items()})
    for seed in seeds(args.fault_seeds):
        got = []
        r = run_cell(args.workload, seed, args.seconds, False,
                     hooks={"step": half_batch}, ctx_out=got)
        emit("fault_half_batch", seed,
             {k: c["value"] for k, c in r["checks"].items()}, worst(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
