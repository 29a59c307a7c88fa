"""The port's span recorder (``core/trace.py``) and the spans at its layer
boundaries: off by default, on under a torch profiler or after
``enable()``, every span of the data path, the training step and the
serving engine recorded with its parent and its root, stamped on
``time.perf_counter``, never a profiler event, and a bounded buffer.

base_ch 4, B=2, T=2, 16x16 on the CPU; no JAX."""

import json
import time

import numpy as np
import pytest
import torch

from unet_convlstm_tpu_torch.core import trace
from unet_convlstm_tpu_torch.data.pipeline import (SequenceLoader,
                                                   prefetch_to_device)
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.ops.normalize import compute_norm_stats
from unet_convlstm_tpu_torch.serve import StreamingPredictor
from unet_convlstm_tpu_torch.train import loop as tloop
from unet_convlstm_tpu_torch.train.checkpoint import save_checkpoint
from unet_convlstm_tpu_torch.train.config import TrainConfig
from unet_convlstm_tpu_torch.train.optim import make_optimizer
from unet_convlstm_tpu_torch.train.steps import make_train_step

MODEL = {"type": "custom", "base_ch": 4, "use_skip_lstm": True,
         "lstm_layers": 1}
B, T, HW = 2, 2, 16
SERVE = ("serve.stage_in", "serve.forward", "serve.stage_out")
STEP = ("step", "step.forward", "step.backward", "step.optim",
        "optim.verdict")
DATA = ("data.gather", "data.stage")
PARENTS = {"step.forward": "step", "step.backward": "step",
           "step.optim": "step", "optim.verdict": "step.optim"}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = rng.gamma(2.0, 0.7, (8, T, HW, HW, 2)).astype(np.float32)
    y = (rng.standard_normal((8, T, HW, HW, 1)) * 3).astype(np.float32)
    return x, y, compute_norm_stats(x, y)


@pytest.fixture(scope="module")
def predictor(batch, tmp_path_factory):
    _, init, _, _ = build_model(MODEL)
    model = init(torch.Generator().manual_seed(0), torch.device("cpu"))
    path = save_checkpoint(
        str(tmp_path_factory.mktemp("trace") / "m.pt"), model.state_dict(),
        MODEL, batch[2].to_dict())
    return StreamingPredictor(path, device="cpu")


@pytest.fixture(scope="module")
def trainer(batch):
    _, init, apply_fn, _ = build_model(MODEL)
    model = init(torch.Generator().manual_seed(0), torch.device("cpu"))
    opt = make_optimizer(model.named_parameters(), 1e-3, skip_nonfinite=3)
    return model, opt, apply_fn


@pytest.fixture
def fresh():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _predict_many(pred, batch):
    sids = [pred.open_session(B, HW, HW) for _ in range(2)]
    try:
        pred.predict_many(sids, [batch[0][:B, :1], batch[0][B:2 * B, :1]])
    finally:
        for sid in sids:
            pred.close_session(sid)


def _predict(pred, batch):
    sid = pred.open_session(B, HW, HW)
    try:
        pred.predict(sid, batch[0][:B, :1])
    finally:
        pred.close_session(sid)


def _step(trainer, batch, accum_steps=1):
    model, opt, apply_fn = trainer
    step = make_train_step(apply_fn, batch[2], guard_nonfinite_stats=True,
                           accum_steps=accum_steps)
    step(model, opt, torch.from_numpy(batch[0][:B]),
         torch.from_numpy(batch[1][:B]))


def _data(batch):
    class Pool:
        def get_batch_raw(self, idx):
            return batch[0][idx], batch[1][idx]

    loader = SequenceLoader(Pool(), np.arange(8), B, seed=0)
    for _ in prefetch_to_device(iter(loader), 2, "cpu"):
        pass


# case: (what runs, its fixture, the span names, the roots in the order
# they end; None where it follows the prefetch's interleaving)
CASES = {"predict_many": (_predict_many, "predictor", SERVE, list(SERVE)),
         "predict": (_predict, "predictor", SERVE, list(SERVE)),
         "step": (_step, "trainer", STEP, ["step"]),
         "accum_step": (lambda tr, b: _step(tr, b, 2), "trainer", STEP,
                        ["step"]),
         "data": (lambda _, b: _data(b), None, DATA, None)}


def _run(case, request, batch):
    fn, fixture = CASES[case][:2]
    fn(request.getfixturevalue(fixture) if fixture else None, batch)


@pytest.mark.parametrize("case", ["predict_many", "step"])
def test_off_by_default(case, request, batch, fresh):
    assert trace.span("x") is trace.OFF
    with trace.span("x") as s:
        assert s is None
    _run(case, request, batch)
    assert trace.spans() == [] and trace.RECORDER.dropped == 0


@pytest.mark.parametrize("how", ["profiler", "enable"])
def test_on_under_a_profiler_or_after_enable(how, fresh):
    if how == "enable":
        trace.enable()
        with trace.span("x", rows=3) as s:
            pass
    else:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with trace.span("x", rows=3) as s:
                pass
        assert trace.span("y") is trace.OFF
    assert isinstance(s, trace.Span)
    assert [(r.name, r.attrs, r.parent, r.root) for r in trace.spans()] == \
        [("x", {"rows": 3}, None, s.id)]
    assert trace.device_ms("x") is None       # no events off the card


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_span_with_its_parent_and_root(case, request, batch, fresh):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        b = time.perf_counter()
        _run(case, request, batch)
        c = time.perf_counter()
    got = trace.spans()
    names = CASES[case][2]
    assert {s.name for s in got} == set(names)
    by_id = {s.id: s for s in got}
    for s in got:
        assert b <= s.start <= s.end <= c          # perf_counter, inside
        want = PARENTS.get(s.name)
        if want is None:
            assert s.parent is None and s.root == s.id
        else:
            assert by_id[s.parent].name == want
            root = by_id[s.root]
            assert root.name == names[0] and root.parent is None
    roots = CASES[case][3]
    if roots is not None:
        assert [s.name for s in got if s.parent is None] == roots
    # no profiler event carries a program span's name
    assert not {e.name for e in prof.events()} & set(names)


def test_the_buffer_keeps_the_newest_and_counts_the_dropped():
    rec = trace.Recorder(cap=3)
    rec.enable()
    for i in range(5):
        with rec.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in rec.spans("s")] == [2, 3, 4]
    assert rec.dropped == 2
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0


def test_fit_profile_dir_writes_the_spans(tmp_path, monkeypatch, fresh):
    rng = np.random.default_rng(0)
    npz = tmp_path / "d.npz"
    np.savez(npz, X=rng.gamma(2.0, 0.7, (10, 3, 2, 16, 16)).astype(
        np.float32), Y=(rng.standard_normal((10, 3, 1, 16, 16)) * 3).astype(
        np.float32))
    cfg = TrainConfig().apply_overrides({
        "batch_size": "8", "epochs": "1", "model.base_ch": "4",
        "mesh_data": "1", "checkpoint_dir": str(tmp_path / "ckpt")})
    cfg.npz_path = str(npz)
    monkeypatch.setattr(tloop, "PROFILE_STEPS", (0, 1))
    tloop.fit(cfg, verbose=False, profile_dir=str(tmp_path / "prof"),
              device="cpu")
    out = json.loads((tmp_path / "prof" / "spans.json").read_text())
    ev = {e["name"]: e for e in out["traceEvents"]}
    fwd = ev["step.forward"]
    assert fwd["ph"] == "X" and fwd["dur"] > 0
    assert fwd["ts"] >= out["perf_counter_start_us"]
    assert fwd["args"]["parent"] == ev["step"]["args"]["id"]
