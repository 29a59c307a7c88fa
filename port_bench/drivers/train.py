"""The training cells: the step as the port's ``fit`` runs it.

Set-up builds one training object (the port's model from the seeded state
dict, ``make_optimizer``, ``make_train_step``), feeds it through the port's
``SequenceLoader`` and ``prefetch_to_device`` from a seeded pool, drives
it through its first three steps, reads what the comparison needs, warms
up, and hands the same object to the window. The window runs steps for
``--seconds`` and ends on a device synchronise. The reference then follows
the first three steps on the same rows.

Traffic keys: ``batch``, ``pool`` (sequences), ``trace_seconds``.
"""

from __future__ import annotations

import functools
import gc
import time

import numpy as np
import torch

from .. import check, inputs, roofline
from ..reference import family
from ..reference import train as ref_train
from ..trace import Profile

BETA1 = 0.9
CHECK_STEPS = 3         # steps the reference follows
WARMUP_STEPS = 2


def _port_objects(ctx, state):
    from unet_convlstm_tpu_torch.models.registry import build_model
    from unet_convlstm_tpu_torch.ops.normalize import NormStats
    from unet_convlstm_tpu_torch.train.optim import make_optimizer
    from unet_convlstm_tpu_torch.train.steps import make_train_step

    m, hp = ctx.config["model"], ctx.config["train"]
    _, init, apply_fn, _ = build_model(dict(m))
    with torch.device("meta"):
        model = init()
    model.load_state_dict(state, strict=True, assign=True)
    apply_fn = functools.partial(apply_fn, use_pallas=True,
                                 use_fused_doubleconv=True,
                                 unroll=ctx.config["seq_len"], remat=False,
                                 flat_layout="time",
                                 **({"policy": ctx.hooks["policy"]}
                                    if "policy" in ctx.hooks else {}))
    mask = {n: family(m).trainable(m, n) for n, _ in model.named_parameters()}
    opt = make_optimizer(model.named_parameters(), hp["lr"],
                         hp["weight_decay"], hp["grad_clip"],
                         trainable_mask=mask,
                         skip_nonfinite=hp["skip_nonfinite"])
    step = make_train_step(apply_fn, NormStats(**ctx.stats),
                           use_mask=hp["use_mask"],
                           grad_weight=hp["grad_weight"],
                           guard_nonfinite_stats=True)
    return model, opt, step


def _feed(loader, dev):
    """Batches on the card across epochs: a new prefetching iterator over
    the loader at each epoch's end, as ``fit`` starts one an epoch."""
    from unet_convlstm_tpu_torch.data.pipeline import prefetch_to_device

    while True:
        it = prefetch_to_device(iter(loader), 2, dev)
        first = next(it, None)
        if first is None:
            raise RuntimeError("the pool holds no whole batch")
        yield first
        yield from it


def _norms(tensors):
    if not tensors:
        return []
    return torch.stack([torch.linalg.vector_norm(t.float())
                        for t in tensors]).tolist()


def run(ctx) -> dict:
    from unet_convlstm_tpu_torch.core.determinism import deterministic
    from unet_convlstm_tpu_torch.data.fast_gather import gather_transpose
    from unet_convlstm_tpu_torch.data.pipeline import SequenceLoader
    from unet_convlstm_tpu_torch.ops.kernels import launch_counts
    from unet_convlstm_tpu_torch.train.optim import nonfinite_step_count

    dev, tr, cfg = ctx.device, ctx.traffic, ctx.config
    m = cfg["model"]
    B, T = tr["batch"], cfg["seq_len"]
    H, W = cfg["image"]
    X, Y = inputs.make_pool(ctx.seed, tr["pool"], T, H, W, dev)
    ctx.stats = inputs.norm_stats(Y, inputs.X_MAX)
    pool = inputs.PoolDataset(X, Y, gather_transpose)
    hooks = ctx.hooks
    readings = {}
    state = inputs.make_state(m, ctx.seed, dev)
    host = inputs.to_host(state)
    with deterministic(dev):
        model, opt, step = _port_objects(ctx, state)
        del state
        if "step" in hooks:
            step = hooks["step"](step)
        loader = SequenceLoader(pool, np.arange(len(pool)), B, shuffle=True,
                                seed=ctx.seed, drop_remainder=True)
        feed = _feed(loader, dev)
        params = dict(model.named_parameters())
        bufs = dict(model.named_buffers())
        names = [n for n in params if family(m).trainable(m, n)]
        stat_names = [n for n in bufs
                      if n.endswith(("running_mean", "running_var"))]
        losses = []
        for k in range(CHECK_STEPS):
            x, y = next(feed)
            loss, _ = step(model, opt, x, y)
            losses.append(float(loss))
            if k == 0:
                st = opt.adamw.state
                got = [n for n in names if params[n] in st]
                readings["grad_norms"] = dict(zip(got, (
                    v / (1 - BETA1) for v in _norms(
                        [st[params[n]]["exp_avg"] for n in got]))))
                readings["commit"] = dict(zip(stat_names, _norms(
                    [bufs[n] - host[n].to(dev) for n in stat_names])))
        readings["losses"] = losses
        start = inputs.to_device(host, dev)
        readings["change"] = dict(zip(names, _norms(
            [params[n].detach() - start[n] for n in names])))
        del start
        for _ in range(WARMUP_STEPS):
            x, y = next(feed)
            step(model, opt, x, y)
        bad0 = nonfinite_step_count(opt)
        ctx.sync()
        steps, t0 = 0, time.perf_counter()
        ctx.setup_s = t0 - ctx.t_start
        end = t0 + ctx.seconds
        trace_at = end - min(tr["trace_seconds"], ctx.seconds) \
            if ctx.trace else float("inf")
        prof = None
        while True:
            now_t = time.perf_counter()
            if now_t >= end:
                break
            if prof is None and now_t >= trace_at:
                prof = Profile(dev)
                prof.start()
                n0, c0 = steps, launch_counts()
            with ctx.spans.span("data_wait"):
                x, y = next(feed)
            with ctx.spans.span("step_call"):
                step(model, opt, x, y)
            steps += 1
        ctx.sync()
        t1 = time.perf_counter()
        if prof is not None:
            prof.stop()
            c1 = launch_counts()
            ctx.traced = {"summary": prof.summary, "units": steps - n0,
                          "t0": prof.t0, "t1": prof.t1,
                          "launches": {k: c1[k] - c0[k] for k in c1}}
        failed = nonfinite_step_count(opt) - bad0
    ctx.memory_peak = ctx.read_peak()
    ctx.window = (t0, t1)
    ctx.units = steps
    ctx.unit_flops = roofline.model_flops(m, B, T, H, W, train=True)
    ctx.unit_launches = roofline.launches(m, B, T, H, W, train=True)
    ctx.unit_counts = roofline.launch_counts(m, B, T, H, W, train=True)
    batches = [(X[i], Y[i]) for i in pool.served[:CHECK_STEPS]]
    del model, opt, step, feed, loader, params, bufs, x, y
    gc.collect()
    ctx.free()
    ref = ref_train.train_steps(inputs.to_device(host, dev), m,
                                cfg["train"], ctx.stats, batches, dev)
    if "control_quant" in hooks:      # the reference in the program's place
        readings = ref_train.train_steps(inputs.to_device(host, dev), m,
                                         cfg["train"], ctx.stats, batches,
                                         dev, quant=hooks["control_quant"])
    ctx.numbers = check.train_numbers(readings, ref)
    ctx.readings = (readings, ref)
    frames = B * T * steps
    return {"attempted": steps, "failed": failed,
            "e2e": {"train_frames_per_s": frames / (t1 - t0),
                    "setup_s": ctx.setup_s}}
