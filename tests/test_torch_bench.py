"""The port's benchmark: the JAX benchmark's batch byte for byte, its JSON
keys, and the ``bench`` subcommand."""

import json

import numpy as np
import pytest

from unet_convlstm_tpu import benchmark as jbench
from unet_convlstm_tpu.data.moving_mnist import (
    generate_moving_mnist, moving_mnist_to_xy, synthetic_digit_bank)
from unet_convlstm_tpu.ops.normalize import compute_norm_stats
from unet_convlstm_tpu_torch import benchmark as tbench
from unet_convlstm_tpu_torch import cli


def test_config_and_batch_are_the_jax_benchmarks():
    assert (tbench.B, tbench.T, tbench.H) == (jbench.B, jbench.T, jbench.H)
    assert (tbench.WARMUP, tbench.ITERS) == (jbench.WARMUP, jbench.ITERS)
    assert tbench.METRIC == jbench.METRIC
    assert tbench.REF_FRAMES_PER_SEC == jbench.REF_FRAMES_PER_SEC
    x, y, stats = tbench.moving_mnist_batch()
    # the JAX benchmark's own construction (benchmark.py:86-92)
    X, Y = moving_mnist_to_xy(generate_moving_mnist(
        seq_len=jbench.T, num_samples=jbench.B, image_size=jbench.H,
        num_digits=2, digits=synthetic_digit_bank(), seed=0))
    assert x.tobytes() == np.ascontiguousarray(np.moveaxis(X, 2, -1)).tobytes()
    assert y.tobytes() == np.ascontiguousarray(np.moveaxis(Y, 2, -1)).tobytes()
    assert x.shape == (64, 10, 64, 64, 2) and y.shape == (64, 10, 64, 64, 1)
    assert stats.to_dict() == compute_norm_stats(X, Y).to_dict()


def test_run_on_the_cpu_prints_the_jax_keys_and_kernels():
    out = tbench.run(device="cpu", batch=1, iters=1, warmup=1)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "batch",
                        "kernels"}
    assert out["metric"] == jbench.METRIC and out["unit"] == "frames/sec/chip"
    assert out["kernels"] is True and out["batch"] == 1
    assert out["value"] > 0


def test_bench_subcommand(monkeypatch, capsys):
    seen = {}

    def fake_run(device=None, kernels=True, **kw):
        seen.update(device=device, kernels=kernels)
        return {"metric": tbench.METRIC, "value": 1.0, "kernels": kernels}

    monkeypatch.setattr(tbench, "run", fake_run)
    cli.main(["bench", "--plain", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0])["kernels"] is False
    assert seen == {"device": "cpu", "kernels": False}


def test_run_without_a_card_does_not_fall_back(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run(batch=1, iters=1, warmup=1)
