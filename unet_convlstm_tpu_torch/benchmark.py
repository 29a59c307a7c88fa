"""Training throughput: frames per second per card, forward + backward +
optimizer (counterpart of unet_convlstm_tpu/benchmark.py).

The JAX benchmark's configuration exactly: Moving-MNIST 64x64 from the
synthetic digit bank at seed 0, sequence length 10, batch 64; the custom
TemporalUNetDualView at base_ch 32 with skip ConvLSTMs, one LSTM layer and
no attention; bf16 compute; AdamW at lr 1e-3 with a global-norm clip of
1.0; 3 warm-up steps, then 20 timed steps on the host clock, ending in a
synchronisation. Weights are random from a seeded generator.

    python -m unet_convlstm_tpu_torch bench [--plain] [--device cpu]

prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "batch",
"kernels"}. ``kernels`` is true when the step runs both hand-written
kernel paths (the gate update and the fused 3x3 conv), false with
``--plain``. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .core.dtypes import resolve_device

REF_FRAMES_PER_SEC = 4.69  # the reference torch model on a CPU host (BASELINE.md)
B, T, H = 64, 10, 64
WARMUP, ITERS = 3, 20
METRIC = "train_frames_per_sec_per_chip_mnist64_seq10_fwd_bwd"
MODEL_CFG = {"type": "custom", "base_ch": 32, "use_skip_lstm": True,
             "use_attention": False, "lstm_layers": 1}


def moving_mnist_batch(batch: int = B):
    """The benchmark's batch at seed 0: raw NHWC (x [B, T, H, W, 2], y [B,
    T, H, W, 1]) float32 numpy arrays, and their normalization stats."""
    from .data.moving_mnist import (generate_moving_mnist, moving_mnist_to_xy,
                                    synthetic_digit_bank)
    from .ops.normalize import compute_norm_stats

    data = generate_moving_mnist(seq_len=T, num_samples=batch, image_size=H,
                                 num_digits=2, digits=synthetic_digit_bank(),
                                 seed=0)
    X, Y = moving_mnist_to_xy(data)
    stats = compute_norm_stats(X, Y)
    x_raw = np.ascontiguousarray(np.moveaxis(X, 2, -1))
    y_raw = np.ascontiguousarray(np.moveaxis(Y, 2, -1))
    return x_raw, y_raw, stats


def run(device=None, kernels: bool = True, batch: int = B,
        iters: int = ITERS, warmup: int = WARMUP) -> dict:
    from .models.registry import build_model
    from .train.optim import make_optimizer
    from .train.steps import make_train_step

    dev = resolve_device(device)
    x_raw, y_raw, stats = moving_mnist_batch(batch)
    _, init, apply, _ = build_model(MODEL_CFG)
    model = init(torch.Generator().manual_seed(0), device=dev)
    opt = make_optimizer(model.named_parameters(), 1e-3)
    step = make_train_step(
        functools.partial(apply, use_pallas=kernels,
                          use_fused_doubleconv=kernels),
        stats, use_mask=False)
    x = torch.from_numpy(x_raw).to(dev)
    y = torch.from_numpy(y_raw).to(dev)

    for _ in range(warmup):
        loss, _ = step(model, opt, x, y)
    float(loss)                       # waits for the device
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, _ = step(model, opt, x, y)
    final_loss = float(loss)
    dt = time.perf_counter() - t0
    if not np.isfinite(final_loss):
        raise RuntimeError(f"benchmark loss is non-finite: {final_loss}")

    fps = batch * T * iters / dt
    return {"metric": METRIC, "value": round(fps, 2),
            "unit": "frames/sec/chip",
            "vs_baseline": round(fps / REF_FRAMES_PER_SEC, 2),
            "batch": batch, "kernels": kernels}
