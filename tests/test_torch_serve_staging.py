"""The serving engine's staging and state groups (unet_convlstm_tpu_torch/
serve.py) where the CPU cannot show them: on a card, the staging buffers
page-locked and every host↔card copy of a request issued non-blocking
(``-m card``; run on a card with ``python -m pytest --noconftest -m card
tests/test_torch_serve_staging.py``); on the CPU, the benchmark's reader of
the state paths' counts. Imports no JAX, so that it runs on the card's
machine."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench.manifest import Manifest
from unet_convlstm_tpu_torch import serve
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.ops.normalize import compute_norm_stats
from unet_convlstm_tpu_torch.serve import StreamingPredictor
from unet_convlstm_tpu_torch.train.checkpoint import save_checkpoint

MODEL = {"type": "custom", "base_ch": 16, "use_skip_lstm": True,
         "lstm_layers": 1}
B, H, W = 2, 32, 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _checkpoint(folder) -> str:
    _, init, _, _ = build_model(dict(MODEL))
    weights = init(torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    x = (rng.random((2, 2, H, W, 2)) * 3).astype(np.float32)
    y = (rng.standard_normal((2, 2, H, W, 1)) * 4).astype(np.float32)
    return save_checkpoint(str(folder / "model.pt"), weights, MODEL,
                           compute_norm_stats(x, y).to_dict())


@pytest.mark.card
def test_staging_is_pinned_and_non_blocking(card, tmp_path, monkeypatch):
    pred = StreamingPredictor(_checkpoint(tmp_path), device=card)
    rng = np.random.default_rng(1)
    blocks = lambda: [(rng.random((B, 1, H, W, 2)) * 3).astype(  # noqa
        np.float32) for _ in range(3)]
    sids = [pred.open_session(B, H, W) for _ in range(3)]
    pred.predict_many(sids, blocks())     # builds the kernels and buffers
    copies = []
    copy_ = torch.Tensor.copy_

    def spy(dst, src, non_blocking=False):
        if dst.device != src.device:
            copies.append((dst, src, non_blocking))
        return copy_(dst, src, non_blocking)

    monkeypatch.setattr(torch.Tensor, "copy_", spy)
    before = serve.state_counts()
    many = pred.predict_many(sids, blocks())
    one = pred.predict(sids[1], blocks()[0])
    after = serve.state_counts()
    monkeypatch.undo()
    # three blocks and one output out, then one block and one output out
    assert len(copies) == 6
    for dst, src, non_blocking in copies:
        host = dst if dst.device.type == "cpu" else src
        assert non_blocking and host.is_pinned()
    assert all(t.is_pinned() for (_, on_device), t in pred._buffers.items()
               if not on_device)
    assert {k: after[k] - before[k] for k in after} == {"resident": 1,
                                                        "gathered": 1}
    kept = [a.copy() for a in many + [one]]
    for _ in range(3):
        pred.predict_many(sids, blocks())
        pred.predict(sids[1], blocks()[0])
    for a, b in zip(many + [one], kept):
        np.testing.assert_array_equal(a, b)


def test_resident_share_reader(monkeypatch):
    """``state_resident_pct.serve``: 100 × resident / (resident +
    gathered) over the run; nothing where no request was served, in a
    training cell, or on a port without the counts."""
    read = Manifest().reader("state_resident_pct.serve")
    view = SimpleNamespace(kind="serve")
    monkeypatch.setattr(serve, "_STATE_PATHS", {"resident": 3,
                                                "gathered": 1})
    assert read(view) == 75.0
    assert read(SimpleNamespace(kind="train")) is None
    monkeypatch.setattr(serve, "_STATE_PATHS", {"resident": 0,
                                                "gathered": 0})
    assert read(view) is None
    monkeypatch.delattr(serve, "state_counts")
    assert read(view) is None
