"""The plain reference agrees with the port computed in float32 (the
port's FP32 policy) on the CPU at a tiny size, through the same harness
that decides ``correct`` on the card."""

from port_bench.harness import run_cell
from port_bench.tests.tiny import fp32_hooks, overrides


def test_custom_training_steps_agree_in_f32():
    r = run_cell("custom_b64.train", 11, 0.2, False, device="cpu",
                 overrides=overrides("custom_b64"), hooks=fp32_hooks("train"))
    got = {k: c["value"] for k, c in r["checks"].items()}
    assert got["update_gap"] < 1e-3
    assert got["bn_gap"] < 1e-4


def test_served_streams_agree_in_f32():
    r = run_cell("custom_b64.serve_streams8", 11, 0.3, False, device="cpu",
                 overrides=overrides("custom_b64"), hooks=fp32_hooks("serve"))
    assert r["checks"]["out_gap"]["value"] < 1e-4
