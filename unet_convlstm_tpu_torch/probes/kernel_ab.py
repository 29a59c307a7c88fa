"""The designs of K1's forward (``csrc/gate_update.cu``) and K7
(``csrc/chained_gather.cu``) against their alternatives on the card, and
both kernels' checks from two checkouts in turn.

    python -m unet_convlstm_tpu_torch.probes.kernel_ab [--parent CHECKOUT]

K1 forward: the shipped build (sigmoids from ``__expf`` and a fast
reciprocal) against the same source with a precise ``expf`` and divide, at
the serving request's three levels (B=4, 128x128, base_ch 64) and the
training step's (B=64, 64x64, base_ch 32), inputs rotated past the L2
cache: microseconds a launch in the order shipped, precise, precise,
shipped, the sums a request and a step, each build's error against the
plain version, ptxas's registers and spills, and the SASS instructions of
the bf16 vector kernel (``cuobjdump -sass``, static count, over the 8
elements one pass of its loop computes).

K7: at the gather probe's five shapes (reps 64), the shipped plan against
the 4-byte layout (next alone in shared memory, x through L1) at the same
tiles, other tiles (1, 8 or 16 lines), half and twice the splits, and the
staging loop not unrolled; each alternative bit-equal to the plain version
and timed in the order shipped, alternative, alternative, shipped.

``--parent``: then chip_smoke.py's K1 forward and K7 checks from CHECKOUT
(P) and from this checkout (C), in the order P, C, C, P, each in its own
process, and the sums a request and a step, and K7's times, of each run.

Every line printed is one JSON object; ``ab`` lines hold the readings. Run
from the root of the checkout, on a card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import List, Optional

import torch

from ..ops.kernels import build, chained_gather, convlstm_fused
from . import probe_gather

DEV = torch.device("cuda")
L2_BYTES = 50 * 2 ** 20            # an H100 SXM's L2 cache
HBM_BYTES_PER_S = 3.35e12          # its device memory, data sheet
SEED = 0

# (pass, level, rows, C, launches a pass)
K1_LEVELS = (("request", "bottleneck", 4 * 8 * 8, 1024, 4),
             ("request", "skip3", 4 * 16 * 16, 512, 4),
             ("request", "skip2", 4 * 32 * 32, 256, 4),
             ("step", "bottleneck", 64 * 4 * 4, 512, 10),
             ("step", "skip3", 64 * 8 * 8, 256, 10),
             ("step", "skip2", 64 * 16 * 16, 128, 10))
K1_PRECISE = [("return __fdividef(1.0f, 1.0f + __expf(-x));",
               "return 1.0f / (1.0f + expf(-x));")]
K7_NO_UNROLL = [("#pragma unroll 4\n    for (int f = threadIdx.x;",
                 "#pragma unroll 1\n    for (int f = threadIdx.x;")]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_us(fn, arg_sets, n: int = 40) -> float:
    """Device time of one ``fn(*args)`` in microseconds: ``n`` calls cycling
    over ``arg_sets``, enqueued behind a spin kernel so that the events time
    the device's work and not the host's."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*arg_sets[0])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2e9, 4e9 * host_s * n + 2e6)))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def copies(make, nbytes: int):
    """Enough independent input sets to exceed twice the L2 cache."""
    return [make() for _ in range(
        max(2, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1)))))]


def ptxas(log: str) -> dict:
    """Registers and spill bytes of each entry function in an ``nvcc
    -Xptxas -v`` log."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if name and m:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if name and m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def sass_count(lib_path: str, *keys: str) -> int:
    """Static SASS instructions of the function whose mangled name holds
    every one of ``keys``."""
    sass = subprocess.run(
        [os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"), "-sass",
         lib_path], capture_output=True, text=True, check=True).stdout
    for body in sass.split("Function : ")[1:]:
        if all(k in body.split("\n", 1)[0] for k in keys):
            return len(re.findall(r"/\*[0-9a-f]{4,}\*/", body))
    raise KeyError(f"no function with {keys} in {lib_path}")


# ---------------------------------------------------------------------------
# K1 forward: fast against precise sigmoids
# ---------------------------------------------------------------------------

def _k1_entry(lib: ctypes.CDLL):
    fn = lib.gate_update_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _k1_call(fn, gates, c):
    C = c.shape[-1]
    p = convlstm_fused.plan_for(gates, c)
    h = torch.empty(c.shape, dtype=gates.dtype, device=DEV)
    cn = torch.empty_like(c)
    rc = fn(gates.data_ptr(), c.data_ptr(), h.data_ptr(), cn.data_ptr(),
            c.numel() // C, C, 1, convlstm_fused.ROUTES.index(p.route),
            p.blocks, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gate_update_fwd: CUDA error {rc}")
    return h, cn


def k1_sigmoids(gen) -> None:
    shipped = build.load("gate_update")
    precise = build.load_variant("gate_update", K1_PRECISE)
    builds = {"shipped": _k1_entry(shipped), "precise": _k1_entry(precise)}
    logs = {"shipped": build.build_dir() / "gate_update.log",
            "precise": os.path.join(os.path.dirname(precise._name),
                                    "gate_update.log")}
    for name, lib in (("shipped", shipped), ("precise", precise)):
        n = sass_count(lib._name, "gate_update_vec_kernel", "bfloat16")
        emit({"ab": "k1_build", "build": name, "ptxas": ptxas(
            open(logs[name]).read()), "sass_vec_bf16": n,
            "sass_per_element": n / 8})
    order = ("shipped", "precise", "precise", "shipped")
    sums = {(per, i): 0.0 for per in ("request", "step")
            for i in range(len(order))}
    for per, level, rows, C, launches in K1_LEVELS:
        def make():
            g = torch.randn(rows, 4 * C, device=DEV, generator=gen) * 2
            return (g.to(torch.bfloat16),
                    torch.randn(rows, C, device=DEV, generator=gen))

        nbytes = rows * C * 18
        sets = copies(make, nbytes)
        h_p, c_p = convlstm_fused.gate_update_plain(*sets[0])
        err = {}
        for name, fn in builds.items():
            h, cn = _k1_call(fn, *sets[0])
            err[name] = {
                "h_abs": (h.float() - h_p.float()).abs().max().item(),
                "h_bit_equal": torch.equal(h, h_p),
                "c_rel": ((cn - c_p).abs() / (1 + c_p.abs())).max().item()}
        us = [device_us(lambda g, c: _k1_call(builds[name], g, c), sets)
              for name in order]
        for i, t in enumerate(us):
            sums[(per, i)] += t * launches
        emit({"ab": "k1_level", "pass": per, "level": level, "rows": rows,
              "C": C, "MB": nbytes / 1e6, "order": order, "us": us,
              "bound_us": nbytes / HBM_BYTES_PER_S * 1e6, "errors": err})
    for per in ("request", "step"):
        emit({"ab": "k1_pass", "pass": per, "order": order,
              "ms": [sums[(per, i)] / 1e3 for i in range(len(order))]})


# ---------------------------------------------------------------------------
# K7: layouts, tiles, splits, unrolling
# ---------------------------------------------------------------------------

def _plan_dict(p: chained_gather.Plan) -> dict:
    return dataclasses.asdict(p)


def k7_alternatives() -> None:
    unrolled1 = build.load_variant("chained_gather", K7_NO_UNROLL)
    emit({"ab": "k7_build", "ptxas": ptxas(
        (build.build_dir() / "chained_gather.log").read_text()),
        "ptxas_unroll_1": ptxas(open(os.path.join(
            os.path.dirname(unrolled1._name), "chained_gather.log")).read())})
    reps = probe_gather.REPS
    for name, shape, axis in probe_gather.VARIANTS:
        x_np, idx_np = probe_gather.variant_inputs(shape, axis)
        x = torch.from_numpy(x_np).to(DEV)
        idx = torch.from_numpy(idx_np).to(DEV)
        ref = chained_gather.chained_gather_plain(x, idx, axis, reps)
        base = chained_gather.plan(*shape, axis)
        alts = [("4-byte layout", chained_gather.plan(*shape, axis, False),
                 None)]
        for lines in (1, 8, 16):
            if lines != base.lines:
                alts.append((f"{lines} lines a tile", chained_gather.plan(
                    *shape, axis, lines=lines), None))
        for k, label in ((0.5, "half the splits"), (2, "twice the splits")):
            splits = max(1, int(base.splits * k))
            if splits != base.splits:
                alts.append((label, chained_gather.plan(
                    *shape, axis, lines=base.lines, splits=splits), None))
        alts.append(("staging not unrolled", base, unrolled1))
        for label, p, lib in alts:
            def run(p, lib):
                return chained_gather._launch(x, idx, axis, reps, p, lib)

            equal = torch.equal(run(p, lib), ref)
            us = [device_us(run, [(q, l)] * 2) for q, l in
                  ((base, None), (p, lib), (p, lib), (base, None))]
            emit({"ab": "k7", "variant": name, "alternative": label,
                  "bit_equal": equal, "order": ["shipped", "alt", "alt",
                                                "shipped"],
                  "us": us, "plan": _plan_dict(p),
                  "shipped_plan": _plan_dict(base)})
            if not equal:
                raise AssertionError(f"K7 {label} disagrees at {name}")


# ---------------------------------------------------------------------------
# two checkouts, P, C, C, P
# ---------------------------------------------------------------------------

# run in each checkout: its chip_smoke.py's K1 forward and K7 checks
TREE_RUN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as s
s.phase_device()
gen = torch.Generator(device=s.DEV).manual_seed(s.SEED)
s.check_k1(gen, s.K1_LEVELS, s.B, "request")
s.check_k1(gen, s.K1_TRAIN_LEVELS, s.TB, "step")
s.check_k7(gen)
"""


def trees(parent: str) -> None:
    here = os.getcwd()
    for run, (tree, root) in enumerate((("P", parent), ("C", here),
                                        ("C", here), ("P", parent))):
        r = subprocess.run([sys.executable, "-c", TREE_RUN], cwd=root,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            raise AssertionError(f"run {run} ({tree}) exited "
                                 f"{r.returncode}")
        k1 = {"request": 0.0, "step": 0.0}
        k7 = {}
        for ln in r.stdout.splitlines():
            obj = json.loads(ln) if ln.startswith("{") else {}
            if obj.get("phase") != "kernel":
                continue
            for per in k1:
                if f"launches_per_{per}" in obj:
                    k1[per] += obj["ms"] * obj[f"launches_per_{per}"]
            if obj["kernel"] == "chained_gather" and "reps" in obj:
                k7[obj["variant"]] = obj["ms"]
        emit({"ab": "tree", "tree": tree, "run": run, "root": root,
              "gate_update_ms": k1, "chained_gather_ms": k7})


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unet_convlstm_tpu_torch.probes.kernel_ab")
    ap.add_argument("--parent", default=None,
                    help="a checkout to compare with this one, P, C, C, P")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    emit({"ab": "device", "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "build_s": build.build_all()})
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    k1_sigmoids(gen)
    k7_alternatives()
    if args.parent:
        trees(os.path.abspath(args.parent))
    return 0


if __name__ == "__main__":
    sys.exit(main())
