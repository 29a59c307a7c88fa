"""The serving cells: ``StreamingPredictor.predict_many``, called
in-process, as docs/SERVING.md deploys the model: concurrent same-geometry
streams advanced together, one fused request a frame time (HTTP: ``POST
/v1/predict-batch``).

``sessions`` streams, each a session of ``batch`` sequences of the image
size; a request advances every session by one frame, raw float32 blocks
[batch, 1, H, W, 2]. A stream is served in runs of ``seq_frames`` frames
(the length the model trains on): its session is opened at a run's first
frame and closed after its last. The streams' runs are staggered evenly,
so that sessions open spread over the requests. Requests arrive open
loop: request k is due at k / ``rate_rps`` seconds into the window. One
thread serves them in due order; a request's latency runs from its due
time to ``predict_many``'s return. A request still unanswered when the
window closes counts at its age then; one that raises counts in
``failed``.

Set-up writes the seeded weights to a checkpoint under ``TMPDIR`` with the
port's ``save_checkpoint`` (the predictor takes a path), loads it, makes
``POOL`` runs of frame blocks from the seed and serves one run's length of
requests (every session opens once, every shape is built). After the
window, ``CHECK_STREAMS`` runs of distinct streams drawn from the seed,
each begun inside the window (finished after it where the window cut
them), are compared with the reference.
"""

from __future__ import annotations

import gc
import math
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from .. import check, inputs, roofline
from ..reference import train as ref_train
from ..trace import Profile

POOL = 16               # runs of frame blocks the streams cycle through
CHECK_STREAMS = 4       # runs compared with the reference


class _Streams:
    def __init__(self, ctx, pred, pool):
        tr = ctx.traffic
        self.ctx, self.pred, self.pool = ctx, pred, pool
        self.S, self.B, self.L = tr["sessions"], tr["batch"], tr["seq_frames"]
        self.H, self.W = ctx.config["image"]
        self.offset = [s * self.L // self.S for s in range(self.S)]
        self.sid = [None] * self.S
        self.k = 0                           # requests served
        rng = np.random.default_rng(ctx.seed)
        streams = rng.choice(self.S, size=min(CHECK_STREAMS, self.S),
                             replace=False)
        # runs 2 and 3 begin after the warm-up's requests
        self.check = {(int(s), int(rng.integers(2, 4))): [None] * self.L
                      for s in streams}
        self.predict_many = pred.predict_many
        if "predict" in ctx.hooks:
            self.predict_many = ctx.hooks["predict"](pred.predict_many)

    def run_of(self, s: int, q: int):
        return self.pool[(s + q * self.S) % len(self.pool)]

    def request(self) -> None:
        """Every stream's next frame, in one ``predict_many``."""
        at = [divmod(self.k + self.offset[s], self.L) for s in range(self.S)]
        for s, (_, f) in enumerate(at):
            if f == 0 or self.sid[s] is None:
                with self.ctx.spans.span("session_open"):
                    if self.sid[s] is not None:
                        self.pred.close_session(self.sid[s])
                    self.sid[s] = self.pred.open_session(self.B, self.H,
                                                         self.W)
        self.k += 1
        ys = self.predict_many(list(self.sid),
                               [self.run_of(s, q)[f]
                                for s, (q, f) in enumerate(at)])
        for s, (q, f) in enumerate(at):
            if (s, q) in self.check:
                self.check[(s, q)][f] = ys[s][:, 0, :, :, 0]

    def finish(self) -> None:
        """Serve on until every sampled run has ended."""
        while any(o is None for outs in self.check.values() for o in outs):
            self.request()


def run(ctx) -> dict:
    from unet_convlstm_tpu_torch.ops.kernels import launch_counts
    from unet_convlstm_tpu_torch.serve import StreamingPredictor
    from unet_convlstm_tpu_torch.train.checkpoint import save_checkpoint

    dev, tr, cfg = ctx.device, ctx.traffic, ctx.config
    m = cfg["model"]
    H, W = cfg["image"]
    L = tr["seq_frames"]
    _, Y = inputs.make_pool(ctx.seed, 8, L, H, W, dev)
    ctx.stats = inputs.norm_stats(Y, inputs.X_MAX)
    del Y
    folder = Path(tempfile.gettempdir()) / "port_bench"
    folder.mkdir(parents=True, exist_ok=True)
    ckpt = folder / f"{ctx.cell['name']}.pt"
    host = inputs.to_host(inputs.seeded_state(m, ctx.seed, dev, (H, W), L))
    save_checkpoint(str(ckpt), host, {"model": dict(m)},
                    norm_stats=ctx.stats)
    try:
        pred = StreamingPredictor(str(ckpt), device=dev)
    finally:
        ckpt.unlink()
    if "predictor" in ctx.hooks:
        pred = ctx.hooks["predictor"](pred)
    pool = inputs.make_streams(ctx.seed, POOL, L, tr["batch"], H, W, dev)
    st = _Streams(ctx, pred, pool)
    for _ in range(L):
        st.request()
    rate = tr["rate_rps"]
    ctx.sync()
    t0 = time.perf_counter()
    ctx.setup_s = t0 - ctx.t_start
    end = t0 + ctx.seconds
    due_n = math.ceil(ctx.seconds * rate)
    trace_at = end - min(tr["trace_seconds"], ctx.seconds) \
        if ctx.trace else float("inf")
    latencies, late, failed, k, prof = [], [], 0, 0, None
    while k < due_n:
        due = t0 + k / rate
        now = time.perf_counter()
        if now >= end:
            break
        if prof is None and now >= trace_at:
            prof = Profile(dev)
            prof.start()
            k0, c0 = k, launch_counts()
            now = time.perf_counter()
        if now < due:
            with ctx.spans.span("await_due"):
                time.sleep(due - now)
            late.append(time.perf_counter() - due)
        with ctx.spans.span("predict"):
            try:
                st.request()
            except Exception:                 # a failed request
                failed += 1
                print(f"request {k} failed:", file=sys.stderr)
                traceback.print_exc()
        latencies.append(min(time.perf_counter(), end) - due)
        k += 1
    t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
        c1 = launch_counts()
        ctx.traced = {"summary": prof.summary, "units": k - k0,
                      "t0": prof.t0, "t1": prof.t1,
                      "launches": {n: c1[n] - c0[n] for n in c1}}
    latencies += [end - (t0 + i / rate) for i in range(k, due_n)]
    if late:
        print(f"generator: {len(late)} of {due_n} requests found the server "
              f"idle; their start after the due time p50 "
              f"{np.percentile(late, 50) * 1e3:.4f} ms, max "
              f"{max(late) * 1e3:.4f} ms", file=sys.stderr)
    st.finish()
    ctx.sync()
    ctx.memory_peak = ctx.read_peak()
    ctx.window = (t0, min(t1, end))
    ctx.units = k
    rows = tr["sessions"] * tr["batch"]
    ctx.unit_flops = roofline.model_flops(m, rows, 1, H, W, train=False)
    ctx.unit_launches = roofline.launches(m, rows, 1, H, W, train=False)
    ctx.unit_counts = roofline.launch_counts(m, rows, 1, H, W, train=False)
    samples = [(st.run_of(s, q), outs) for (s, q), outs in st.check.items()]
    del st, pred
    gc.collect()
    ctx.free()
    prog, ref = [], []
    state = inputs.to_device(host, dev)
    quant = ctx.hooks.get("control_quant")
    for frames, outs in samples:
        ref += [r.numpy() for r in ref_train.serve_stream(
            state, m, ctx.stats, frames, dev)]
        if quant is not None:         # the reference in the program's place
            outs = [r.numpy() for r in ref_train.serve_stream(
                state, m, ctx.stats, frames, dev, quant=quant)]
        prog += outs
    ctx.numbers = check.serve_numbers(prog, ref, ctx.stats["y_scale"])
    lat_ms = np.asarray(latencies) * 1e3
    return {"attempted": due_n, "failed": failed,
            "e2e": {"serve_latency_ms_p50": float(np.percentile(lat_ms, 50)),
                    "serve_latency_ms_p95": float(np.percentile(lat_ms, 95)),
                    "setup_s": ctx.setup_s}}
