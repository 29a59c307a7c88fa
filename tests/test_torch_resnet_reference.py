"""The ResNet18-UNet (the reference repository's default model) served
through the port's normal path against the benchmark's plain reference
(``port_bench/reference/resnet18.py``), on seeded random weights in
float32 on the CPU at a small size: ``predict_many`` frame by frame, a
session closed and reopened into its slot; the reference's state dict
loaded into the port with ``strict=True``; the reference's imports; the
yardstick's launches and FLOPs against hand-worked numbers and the port's
own calls; the model's spans nested in the serving and training forwards
of both families. Imports no JAX."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import check, inputs, roofline
from port_bench.reference import resnet18 as ref
from port_bench.reference import train as ref_train
from unet_convlstm_tpu_torch import serve
from unet_convlstm_tpu_torch.core import trace
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.ops import blocks, convlstm
from unet_convlstm_tpu_torch.ops.normalize import compute_norm_stats
from unet_convlstm_tpu_torch.serve import StreamingPredictor
from unet_convlstm_tpu_torch.train.checkpoint import save_checkpoint
from unet_convlstm_tpu_torch.train.loop import _trainable_mask
from unet_convlstm_tpu_torch.train.optim import make_optimizer
from unet_convlstm_tpu_torch.train.steps import make_train_step

ROOT = Path(__file__).resolve().parents[1]
M = {"type": "resnet18", "freeze_encoder": True, "lstm_layers": 2,
     "in_channels": 2, "out_channels": 1}
B, T, HW = 2, 3, 64
SEED = 2 ** 31 + 77          # wider than 32 signed bits, as --seed may be
# float32 on both sides, the port's NHWC convs against the reference's
# NCHW ones: they differ by the order of each sum, about 1e-7 of a value
# an operation, carried through some forty convs and three recurrent
# steps; 1.3e-5 measured in the model's space (asinh, check.out_gap);
# 1e-4 bounds it, where the port's bf16 path reads about 0.3
OUT_GAP_F32 = 1e-4


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The seeded, calibrated weights (float32, the reference's names),
    the normalization manifest, and a checkpoint the port saved of them
    with the configuration as the benchmark saves it."""
    state = inputs.seeded_state(M, SEED, "cpu", (HW, HW), T)
    _, y = inputs.make_pool(SEED, 8, T, HW, HW, "cpu")
    stats = inputs.norm_stats(y, inputs.X_MAX)
    path = save_checkpoint(
        str(tmp_path_factory.mktemp("resnet_ref") / "m.pt"),
        inputs.to_host(state), {"model": dict(M)}, norm_stats=stats)
    return state, stats, path


def test_predict_many_follows_the_reference_frame_by_frame(served):
    """Two sessions of B=2 advanced together by ``predict_many``; after
    two frames the second is closed and a new session opened into its
    slot, which starts from a zero state. Every frame of every run agrees
    with the reference's forward over that run from a zero state, and
    every request went to the step on the resident path."""
    state, stats, path = served
    pred = StreamingPredictor(path, device="cpu")
    pred.policy = FP32_POLICY
    rng = np.random.default_rng(0)
    runs = (rng.random((3, T, B, 1, HW, HW, 2))
            * inputs.X_MAX).astype(np.float32)
    sids = [pred.open_session(B, HW, HW) for _ in range(2)]
    got = {0: [], 1: [], 2: []}
    before = serve.state_counts()
    for f in range(T):
        second = (1, f) if f < 2 else (2, f - 2)
        if f == 2:
            assert pred.close_session(sids[1])
            sids[1] = pred.open_session(B, HW, HW)
            assert pred._sessions[sids[1]].slot == 1
        ys = pred.predict_many(sids, [runs[0][f], runs[second[0]][second[1]]])
        got[0].append(ys[0][:, 0, :, :, 0])
        got[second[0]].append(ys[1][:, 0, :, :, 0])
    after = serve.state_counts()
    assert {k: after[k] - before[k] for k in after} == {"resident": T,
                                                        "gathered": 0}
    prog, want = [], []
    for r, outs in got.items():
        want += [w.numpy() for w in ref_train.serve_stream(
            state, M, stats, list(runs[r][:len(outs)]), "cpu")]
        prog += outs
    gap = check.serve_numbers(prog, want, stats["y_scale"])["out_gap"]
    assert gap < OUT_GAP_F32


def test_the_reference_state_dict_loads_into_the_port_strict():
    """``specs`` names every parameter and buffer of the published model:
    the port's own, and ``lstm_skips.0``, which the port drops as it
    loads. The decoder's conv biases, which the published model lacks,
    load as zeros. The configuration's parameter count is the port's."""
    state = inputs.make_state(M, 1, "cpu")
    names = [n for n, _, _ in ref.specs(M)]
    assert list(state) == names and len(set(names)) == len(names)
    dropped = {n for n in names if n.startswith("lstm_skips.0.")}
    assert len(dropped) == 2 * M["lstm_layers"]
    _, init, _, _ = build_model(dict(M, pretrained_resolved=True))
    with torch.device("meta"):
        model = init()
    assert set(model.state_dict()) == set(names) - dropped
    model.load_state_dict(state, strict=True, assign=True)
    for k, v in model.state_dict().items():
        assert v.shape == state[k].shape, k
    biases = [n for n, _, kind in ref.specs(M) if kind == "zero"]
    assert len(biases) == 10 and not any(state[n].any() for n in biases)
    cfg = json.loads((ROOT / "port_bench/configs/resnet18_frozen.json")
                     .read_text())
    assert cfg["model"] == M and cfg["reduced"] == []
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]



def test_what_the_reference_trains():
    """The frozen encoder and the decoder's conv biases, which the
    published model lacks, do not train; everything else does."""
    specs = ref.specs(M)
    held = {n for n, _, kind in specs if kind == "zero"}
    for name, _, kind in specs:
        if kind not in ("w", "b", "bn_w", "bn_b", "zero"):
            continue
        expect = not (name.startswith("encoder.") or name in held)
        assert ref.trainable(M, name) is expect, name
    assert ref.trainable(dict(M, freeze_encoder=False),
                         "encoder.conv1.weight")

def test_the_reference_imports_nothing_of_the_port_or_jax():
    """Its own imports are torch and the benchmark's plain layers; loaded
    alone it brings in no module of either package and no JAX."""
    tree = ast.parse((ROOT / "port_bench/reference/resnet18.py")
                     .read_text())
    mods = {(n.module or "", n.level) for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom)}
    mods |= {(a.name, 0) for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    assert mods == {("__future__", 0), ("typing", 0), ("torch", 0),
                    ("torch.nn.functional", 0), ("", 2), ("", 1),
                    ("train", 1)}
    code = ("import sys, port_bench.reference.resnet18\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'unet_convlstm_tpu', "
            "'unet_convlstm_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_computes_in_float32_without_tf32(served):
    """Every conv of a forward sees float32 operands with TF32 off, with
    the flags set on around it and restored after it."""
    state, _, _ = served
    seen = []

    def spy(t):
        seen.append((t.dtype, torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return t

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.rand(1, 1, 2, 32, 32)
        ref.forward(state, M, x, quant=spy)
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert seen and set(seen) == {(torch.float32, False, False)}


# hand-worked FLOPs (2 a multiply-add) of one 128x128 frame's forward
_ENCODER = (64 * 64 * 2 * 64 * 49 * 2                    # the 7x7 stem
            + 4 * 32 * 32 * 64 * 64 * 9 * 2              # layer1
            + 3 * (2 ** 28))        # layer2-4: each 37.7 + 75.5 + 4.2 + 151 M
_GATES = 2 * 144 * (16 * 512 ** 2 + 4096 * 64 ** 2 + 1024 * 64 ** 2
                    + 256 * 128 ** 2 + 64 * 256 ** 2)   # h·w·2C·4C·9·2
_DECODER = (3 * (226_492_416 + 75_497_472)               # blocks 0-2
            + 4096 * 128 * 32 * 18 + 4096 * 32 * 32 * 18   # block 3
            + 16384 * 32 * 16 * 18 + 16384 * 16 * 16 * 18  # block 4
            + 16384 * 16 * 18)                              # the head


def test_the_yardstick_counts_the_family_by_hand(monkeypatch):
    """A request of the cell (64 sequence rows, one frame, 128x128): ten
    gate updates on K1 and no fused conv; its K1 bytes and its model
    FLOPs as worked out by hand (the gate convs 78% of 12.34 GFLOP a
    frame). On the CPU route the port's forward calls the gate update and
    the fused conv as often as the yardstick counts."""
    rows = 64
    assert roofline.launch_counts(M, rows, 1, 128, 128, train=False) == {
        "gate_update": 10, "gate_update_bwd": 0, "conv3x3_fused": 0}
    k1 = roofline.launches(M, rows, 1, 128, 128, train=False)
    assert [l.kernel for l in k1] == ["k1"] * 10
    # bf16 gates (4C) and f32 c in, bf16 h and f32 c' out: 18 B a channel
    assert sum(l.nbytes for l in k1) == rows * 18 * 2 * 385_024
    assert _ENCODER == 1_158_676_480 and _DECODER == 1_514_668_032
    per_frame = _ENCODER + _GATES + _DECODER
    assert per_frame == 12_337_020_928
    assert roofline.model_flops(M, rows, 1, 128, 128, False) == \
        rows * per_frame
    assert 0.78 < _GATES / per_frame < 0.79

    calls = {"gate": 0, "conv3x3": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(convlstm, "fused_gate_update",
                        counting("gate", convlstm.fused_gate_update))
    monkeypatch.setattr(blocks, "fused_conv3x3",
                        counting("conv3x3", blocks.fused_conv3x3))
    _, init, apply_fn, _ = build_model(dict(M, pretrained_resolved=True))
    model = init(torch.Generator().manual_seed(0)).eval()
    steps = 2
    with torch.inference_mode():
        apply_fn(model, torch.rand(1, steps, HW, HW, 2), use_pallas=True,
                 use_fused_doubleconv=True)
    want = roofline.launch_counts(M, 1, steps, HW, HW, train=False)
    assert calls == {"gate": want["gate_update"],
                     "conv3x3": want["conv3x3_fused"]} == {"gate": 20,
                                                           "conv3x3": 0}


FAMILIES = {"custom": {"type": "custom", "base_ch": 4,
                       "use_skip_lstm": True, "lstm_layers": 1},
            "resnet18": M}
MODEL_SPANS = ("model.encoder", "model.recurrence", "model.decoder")


@pytest.fixture
def recording():
    trace.clear()
    trace.enable()
    yield
    trace.disable()
    trace.clear()


def _serve(cfg, tmp_path):
    rng = np.random.default_rng(1)
    x = (rng.random((B, 1, 32, 32, 2)) * 3).astype(np.float32)
    y = (rng.standard_normal((B, 1, 32, 32, 1)) * 4).astype(np.float32)
    _, init, _, _ = build_model(dict(cfg, pretrained_resolved=True))
    path = save_checkpoint(str(tmp_path / "m.pt"),
                           init(torch.Generator().manual_seed(0))
                           .state_dict(), cfg,
                           compute_norm_stats(x, y).to_dict())
    pred = StreamingPredictor(path, device="cpu")
    sids = [pred.open_session(1, 32, 32) for _ in range(B)]
    trace.clear()
    pred.predict_many(sids, [x[i:i + 1] for i in range(B)])
    return "serve.forward"


def _step(cfg, tmp_path):
    rng = np.random.default_rng(1)
    x = (rng.random((B, 2, 32, 32, 2)) * 3).astype(np.float32)
    y = (rng.standard_normal((B, 2, 32, 32, 1)) * 4).astype(np.float32)
    model_cfg = dict(cfg, pretrained_resolved=True)
    _, init, apply_fn, _ = build_model(model_cfg)
    model = init(torch.Generator().manual_seed(0))
    opt = make_optimizer(model.named_parameters(), 1e-3,
                         trainable_mask=_trainable_mask(model, model_cfg))
    step = make_train_step(apply_fn, compute_norm_stats(x, y))
    trace.clear()
    step(model, opt, torch.from_numpy(x), torch.from_numpy(y))
    return "step.forward"


@pytest.mark.parametrize("where", ["serve", "step"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_model_spans_nest_in_the_forward(family, where, tmp_path,
                                             recording):
    """One request or training step of either family records the model's
    three spans once each, in order, as children of the serving engine's
    or the step's forward."""
    parent = {"serve": _serve, "step": _step}[where](FAMILIES[family],
                                                     tmp_path)
    got = trace.spans()
    by_id = {s.id: s for s in got}
    model = [s for s in got if s.name.startswith("model.")]
    assert [s.name for s in sorted(model, key=lambda s: s.start)] == \
        list(MODEL_SPANS)
    for s in model:
        assert by_id[s.parent].name == parent
        assert s.device_ms() is None          # no events off the card
