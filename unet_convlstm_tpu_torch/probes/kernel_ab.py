"""The designs of K1's forward (``csrc/gate_update.cu``), K7
(``csrc/chained_gather.cu``) and K8 (``csrc/conv_int8.cu``) against their
alternatives on the card, and the kernels' checks from two checkouts in
turn.

    python -m unet_convlstm_tpu_torch.probes.kernel_ab [--kernels k1,k7,k8]
        [--parent CHECKOUT]
    python -m unet_convlstm_tpu_torch.probes.kernel_ab \
        --kernels k2,step,renders --parent CHECKOUT

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

K8 (``csrc/conv_int8.cu``): its quantizer in the prologue (the shipped
design: a bf16 x and a calibrated static scale, quantized in shared memory
by every block that stages it) against a separate one-pass quantize (a
kernel built into a variant of the same source with the prologue's own
arithmetic, x read once, x_q written once) followed by K8's int8-input
route, at every distinct shape of the two int8 paths (chip_smoke.py's
K8_CUSTOM and K8_RESNET), bit-equal checked and timed in the order fused,
separate, separate, fused, with the winner per shape and the sums a pass.

``--kernels`` picks among k1, k7 and k8 (all by default), and k2, step and
renders, which have no alternative here and run with ``--parent`` only.
``--parent``: then chip_smoke.py's checks of the chosen kernels from
CHECKOUT (P) and from this checkout (C), in the order P, C, C, P, each in
its own process: K1 forward's sums a request and a step and K7's times;
K8's sums a custom int8 forward and a resnet request (its "ms", and where
the tree reports them its int8-input and dynamic times), and the seeded
base_ch-64 int8 forward (B=8, T=12, 128x128) dynamic, calibrated and bf16,
as phase 13 builds it; K2's sums a request (B=4, T=4, 128x128, base_ch 64)
and a step (B=64, T=10, 64x64, base_ch 32) and its milliseconds at each
training shape; ``step``: the training step's p50 and p90 over chip_smoke's
20 timed steps of the benchmark's configuration (bf16, the kernels on),
under the tree's own training settings (``core.determinism`` where the
tree has it), and where it has them, in the same process, without them,
with them and the NaN fill of new tensors on, and with them again
(``train_step_split``); ``renders``: the wall seconds of five ``gen-renders``
runs (stage B's deterministic renderer) on chip_smoke's two production
patches (200 layers, 128x128) and a 2-view overpass CSV at 256x256.

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
# K8: the quantizer in the prologue against a separate one-pass quantize
# ---------------------------------------------------------------------------

K8_ANCHOR = 'extern "C" int conv_int8('
K8_QUANTIZE_PASS = r"""
// A one-pass activation quantizer, the alternative to K8's prologue: a bf16
// x -> x_q int8 with the prologue's own arithmetic, 16 bytes of x a thread.
__global__ void conv_int8_quantize_kernel(const Params p, const uint4* x,
                                          uint2* xq, long long n) {
  const Quant q = make_quant(p);
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256)
    xq[i] = quant_vec(x[i], q, static_cast<const bf16*>(nullptr));
}

extern "C" int conv_int8_quantize(const void* x, const void* scale,
                                  void* xq, long long n, void* stream) {
  Params p = {};
  p.scale = scale;            // x_s, f32 (scale_mode 0)
  const long long vecs = n / 8;
  const long long blocks = (vecs + 255) / 256;
  conv_int8_quantize_kernel<<<(int)(blocks < 4224 ? blocks : 4224), 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const uint4*>(x), static_cast<uint2*>(xq), vecs);
  return (int)cudaGetLastError();
}

"""


def _chip_smoke():
    """The checkout's chip_smoke.py (run from its root): K8's shape lists
    and argument makers."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    return chip_smoke


def k8_fused_vs_separate(gen) -> None:
    s = _chip_smoke()
    lib = build.load_variant("conv_int8", [(K8_ANCHOR,
                                            K8_QUANTIZE_PASS + K8_ANCHOR)])
    qfn = lib.conv_int8_quantize
    qfn.restype = ctypes.c_int
    qfn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                            ctypes.c_void_p]

    def quantize(x, xs):
        xq = torch.empty(x.shape, dtype=torch.int8, device=DEV)
        rc = qfn(x.data_ptr(), xs.data_ptr(), xq.data_ptr(), x.numel(),
                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"conv_int8_quantize: CUDA error {rc}")
        return xq

    order = ("fused", "separate", "separate", "fused")
    for path, convs in (("int8_forward", s.K8_CUSTOM),
                        ("resnet_int8_request", s.K8_RESNET)):
        sums = [0.0] * len(order)
        wins = {"fused": 0, "separate": 0}
        for kind, n, h, w, cin, cout, k, stride, pad, per in convs:
            fused = s._k8_call(kind, stride, pad, torch.bfloat16, quant=True)
            conv = s._k8_call(kind, stride, pad, torch.bfloat16)

            def separate(x, wq, ws, xs, b):
                return conv(quantize(x, xs), wq, ws, xs, b)

            def make():
                xf, _, wq, ws, _, b = s._k8_args(gen, kind, n, h, w, cin,
                                                 cout, k)
                xs = xf.abs().amax() / torch.tensor(127.0, device=DEV)
                return xf.to(torch.bfloat16), wq, ws, xs, b

            sets = copies(make, 3 * n * h * w * cin + cin * cout * k * k)
            equal = torch.equal(fused(*sets[0]), separate(*sets[0]))
            fns = {"fused": fused, "separate": separate}
            us = [device_us(fns[name], sets) for name in order]
            q_us = device_us(quantize, [(a[0], a[3]) for a in sets])
            f_us, s_us = (us[0] + us[3]) / 2, (us[1] + us[2]) / 2
            win = "fused" if f_us <= s_us else "separate"
            wins[win] += 1
            for i, t in enumerate(us):
                sums[i] += t * per
            emit({"ab": "k8_quantize", "path": path, "kind": kind, "N": n,
                  "H": h, "W": w, "cin": cin, "cout": cout, "k": k,
                  "stride": stride, "launches_per_pass": per,
                  "bit_equal": equal, "order": order, "us": us,
                  "quantize_pass_us": q_us, "winner": win,
                  "plan": dataclasses.asdict(s.k8_plan(
                      kind, n, h, w, cin, cout, k, stride, pad))})
            del sets
            if not equal:
                raise AssertionError(f"K8 fused and separate differ at "
                                     f"{(kind, n, h, w, cin, cout, k)}")
        torch.cuda.empty_cache()
        emit({"ab": "k8_quantize_pass", "path": path, "order": order,
              "ms": [t / 1e3 for t in sums], "shapes_won": wins})


# ---------------------------------------------------------------------------
# two checkouts, P, C, C, P
# ---------------------------------------------------------------------------

# run in each checkout: its chip_smoke.py's checks of the chosen kernels
TREE_RUN = {"head": """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as s
s.phase_device()
gen = torch.Generator(device=s.DEV).manual_seed(s.SEED)
""", "k1": """
s.check_k1(gen, s.K1_LEVELS, s.B, "request")
s.check_k1(gen, s.K1_TRAIN_LEVELS, s.TB, "step")
""", "k2": """
s.check_k2(gen, s.K2_CONVS, s.B * s.T, "request", serving=False)
s.check_k2(gen, s.K2_TRAIN_CONVS, s.TB * s.TT, "step", serving=False)
""", "step": """
import contextlib
try:
    from unet_convlstm_tpu_torch.core.determinism import deterministic
except ImportError:          # a tree from before the deterministic run
    deterministic = None
tr = s._Train()
opt = tr.fresh()
steps = {True: tr.step(s.DEFAULT_POLICY, True),
         False: tr.step(s.DEFAULT_POLICY, False)}
with deterministic(s.DEV) if deterministic else contextlib.nullcontext():
    runs, _ = tr.step_times(opt, steps)
print(json.dumps({"train_step": runs}), flush=True)
if deterministic:            # where the deterministic settings' cost goes
    import torch.utils.deterministic as td
    split = {"no_flags": tr.step_times(opt, steps)[0]}
    with deterministic(s.DEV):
        td.fill_uninitialized_memory = True
        split["with_nan_fill"] = tr.step_times(opt, steps)[0]
    with deterministic(s.DEV):
        split["shipped_again"] = tr.step_times(opt, steps)[0]
    print(json.dumps({"train_step_split": split}), flush=True)
""", "renders": """
import contextlib, os, pickle, tempfile, time
walls = []
with tempfile.TemporaryDirectory() as w:
    root = os.path.join(w, "patches")
    for k in range(1, 7):
        os.makedirs(os.path.join(root, f"{k:010d}"))
    os.makedirs(os.path.join(root, f"{7:010d}"))
    for i, beta in enumerate(s.mc_patches().values()):
        with open(os.path.join(root, f"{7:010d}", f"sample_{i:03d}.pkl"),
                  "wb") as f:
            pickle.dump({"beta_ext": beta}, f)
    csv = s.synthesize_overpass_csv(os.path.join(w, "overpass.csv"),
                                    n_times=7, n_satellites=2)
    for rep in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            s.cli_main(["gen-renders", "--input", root, "--csv", csv,
                        "--res", str(s.MC_RES), "--output",
                        os.path.join(w, f"out{rep}")])
        walls.append(time.perf_counter() - t0)
print(json.dumps({"gen_renders_s": walls}), flush=True)
""", "k7": """
s.check_k7(gen)
""", "k8": """
s.check_k8(gen, s.K8_CUSTOM, "int8_forward")
s.check_k8(gen, s.K8_RESNET, "resnet_int8_request")
import functools
import numpy as np
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.ops.normalize import (compute_norm_stats,
                                                   normalize_x)
from unet_convlstm_tpu_torch.ops.quant import calibrate_tree, quantize_model
rng = np.random.default_rng(s.SEED + 7)
_, init, apply, _ = build_model({"type": "custom", "base_ch": s.BASE})
model = init(torch.Generator().manual_seed(s.SEED + 7), device=s.DEV)
X = rng.gamma(2.0, 0.6, (s.IB, s.IT, s.HW, s.HW, 2)).astype(np.float32)
Y = (rng.standard_normal((s.IB, s.IT, s.HW, s.HW, 1)) * 5).astype(np.float32)
xn = normalize_x(torch.from_numpy(X).to(s.DEV), compute_norm_stats(X, Y))
kern = functools.partial(apply, use_pallas=True, use_fused_doubleconv=True)
s.calibrate_bn(model, xn[:s.B, :s.T])
model.eval()
qmodel = quantize_model(model)
cmodel = calibrate_tree(kern, qmodel, [xn])
with torch.inference_mode():
    print(json.dumps({"forward_ms": {
        name: s._forward_ms(lambda m=m: kern(m, xn))
        for name, m in (("bf16", model), ("int8_dynamic", qmodel),
                        ("int8_calibrated", cmodel))}}), flush=True)
"""}


def trees(parent: str, kernels) -> None:
    here = os.getcwd()
    code = TREE_RUN["head"] + "".join(TREE_RUN[k] for k in kernels)
    for run, (tree, root) in enumerate((("P", parent), ("C", here),
                                        ("C", here), ("P", parent))):
        r = subprocess.run([sys.executable, "-c", code], cwd=root,
                           capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            raise AssertionError(f"run {run} ({tree}) exited "
                                 f"{r.returncode}")
        k1 = {"request": 0.0, "step": 0.0}
        k2 = {"request": 0.0, "step": 0.0, "step_shapes": {}}
        k7, k8, forward, step = {}, {}, None, None
        split, renders = None, None
        for ln in r.stdout.splitlines():
            obj = json.loads(ln) if ln.startswith("{") else {}
            forward = obj.get("forward_ms", forward)
            step = obj.get("train_step", step)
            split = obj.get("train_step_split", split)
            renders = obj.get("gen_renders_s", renders)
            if obj.get("phase") != "kernel":
                continue
            sums = k2 if obj["kernel"] == "conv3x3_fused" else k1
            for per in ("request", "step"):
                if f"launches_per_{per}" in obj:
                    sums[per] += obj["ms"] * obj[f"launches_per_{per}"]
            if obj["kernel"] == "conv3x3_fused" and "launches_per_step" \
                    in obj:
                k2["step_shapes"][str(obj["shape"])] = obj["ms"]
            if obj["kernel"] == "chained_gather" and "reps" in obj:
                k7[obj["variant"]] = obj["ms"]
            if obj["kernel"] == "conv_int8" and "ms" in obj:
                sums = k8.setdefault(obj["path"], {})
                for key in ("ms", "ms_int8_input", "ms_dynamic"):
                    if key in obj:
                        sums[key] = (sums.get(key, 0.0)
                                     + obj[key] * obj["launches_per_pass"])
        emit({"ab": "tree", "tree": tree, "run": run, "root": root,
              "gate_update_ms": k1, "conv3x3_fused_ms": k2,
              "chained_gather_ms": k7, "conv_int8_ms": k8,
              "int8_forward_ms": forward, "train_step": step,
              "train_step_split": split, "gen_renders_s": renders})


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unet_convlstm_tpu_torch.probes.kernel_ab")
    ap.add_argument("--parent", default=None,
                    help="a checkout to compare with this one, P, C, C, P")
    ap.add_argument("--kernels", default="k1,k7,k8",
                    help="a comma-separated choice of k1, k2, k7, k8, "
                         "step and renders (k2, step and renders: with "
                         "--parent only)")
    args = ap.parse_args(argv)
    kernels = [k for k in ("k1", "k2", "k7", "k8", "step", "renders")
               if k in args.kernels.split(",")]
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    emit({"ab": "device", "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "build_s": build.build_all()})
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    if "k1" in kernels:
        k1_sigmoids(gen)
    if "k7" in kernels:
        k7_alternatives()
    if "k8" in kernels:
        k8_fused_vs_separate(gen)
    if args.parent:
        trees(os.path.abspath(args.parent), kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
