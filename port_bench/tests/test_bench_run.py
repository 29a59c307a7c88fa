"""The command refuses to run without a card, and a run whose timed path
is broken underneath comes out not correct: a step that leaves the state
unchanged, a step that leaves out half of the batch, an answer altered
where it is produced. (One card: no exchange between chips to leave out.)
The look for a card is skipped by calling the harness directly."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench.controls import half_batch
from port_bench.harness import run_cell
from port_bench.tests.tiny import overrides

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "custom_b64.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_no_port_no_result(tmp_path):
    """From a directory that holds only BENCHMARK.json and port_bench."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "custom_b64.train", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


def _unchanged(step):
    def broken(model, opt, x, y):
        return torch.zeros(()), None
    return broken


def _altered(predict_many):
    def broken(sids, blocks):
        ys = predict_many(sids, blocks)
        for y in ys:          # each stream's first sequence
            y[0] = 0.0
        return ys
    return broken


TRAIN = [("custom_b64.train", "custom_b64")]
SERVE = [("custom_b64.serve_streams8", "custom_b64")]


@pytest.mark.parametrize("fault", [_unchanged, half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell,config", TRAIN)
def test_broken_step_is_not_correct(cell, config, fault):
    r = run_cell(cell, 7, 0.2, False, device="cpu",
                 overrides=overrides(config), hooks={"step": fault})
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell,config", SERVE)
def test_altered_answer_is_not_correct(cell, config):
    r = run_cell(cell, 7, 0.3, False, device="cpu",
                 overrides=overrides(config), hooks={"predict": _altered})
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell,config", TRAIN + SERVE)
def test_result_line_shape(cell, config):
    r = run_cell(cell, 5, 0.3, True, device="cpu",
                 overrides=overrides(config))
    json.dumps(r)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(c["limit"] is not None for c in r["checks"].values())


@pytest.mark.parametrize("numbers,limits,correct", [
    ({"gap": 0.1}, {"gap": 0.2}, True),
    ({"gap": 0.3}, {"gap": 0.2}, False),
    ({"gap": 0.1}, {}, False),                      # no limits file
    ({"gap": 0.1, "other": 0.0}, {"gap": 0.2}, False),   # no limit
    ({"gap": 0.1}, {"gap": 0.2, "typo": 1.0}, False),    # no number
    ({"gap": float("nan")}, {"gap": 0.2}, False),
    ({}, {}, False)])
def test_verdict_judges_every_number(numbers, limits, correct):
    from port_bench.check import verdict

    assert verdict(numbers, limits)[0] is correct
