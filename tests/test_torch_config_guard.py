"""The port's TrainConfig and TrainingGuard against the JAX package's: the
same keys and defaults, the same override results or errors, the repo's
config files loaded the same, and the same guard decisions and state."""

import json
import math
import pathlib

import pytest

from unet_convlstm_tpu.train.config import TrainConfig as JCfg
from unet_convlstm_tpu.train.guard import TrainingGuard as JGuard
from unet_convlstm_tpu_torch.train.config import TrainConfig as TCfg
from unet_convlstm_tpu_torch.train.config import check_mesh
from unet_convlstm_tpu_torch.train.guard import TrainingGuard as TGuard

CONFIGS = sorted((pathlib.Path(__file__).resolve().parents[1] / "configs")
                 .glob("*.json"))


def test_defaults_equal_jax():
    assert TCfg().to_dict() == JCfg().to_dict()


@pytest.mark.parametrize("overrides", [
    {"epochs": "3", "lr": "5e-4", "use_mask": "yes", "guard": "0"},
    {"model.base_ch": "16", "model.freeze_encoder": "false",
     "model.name": "x"},
    {"mesh_data": "4", "min_y": "-2.5", "max_y": "none",
     "skip_nonfinite_updates": "3"},
    {"min_y": "abc", "checkpoint_dir": "ck", "guard_snapshot": "host"},
    {"epochz": "3"},
    {"model.base_ch": "x"},
])
def test_overrides_equal_jax(overrides):
    try:
        want = JCfg().apply_overrides(overrides).to_dict()
    except Exception as e:                      # the same error, or none
        with pytest.raises(type(e)) as got:
            TCfg().apply_overrides(overrides)
        assert str(got.value) == str(e)
        return
    assert TCfg().apply_overrides(overrides).to_dict() == want


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_repo_configs_load_equal(path):
    d = json.loads(path.read_text())
    assert TCfg.from_dict(d).to_dict() == JCfg.from_dict(d).to_dict()


@pytest.mark.parametrize("over", [{"mesh_data": "2"}, {"mesh_model": "2"},
                                  {"zero1": "true"}])
def test_multi_device_keys_raise(over):
    """Data parallelism and ZeRO-1 (item 7a) and a tensor-parallel mesh
    (item 7b) pass the config check; a degree below 1 raises."""
    check_mesh(TCfg().apply_overrides({"mesh_data": "1"}))
    check_mesh(TCfg().apply_overrides(over))
    for key in ("mesh_data", "mesh_model"):
        cfg = TCfg().apply_overrides({**over, key: "0"})
        with pytest.raises(ValueError, match="must be >= 1"):
            check_mesh(cfg)


def test_guard_decisions_and_state_equal_jax():
    losses = [(1.0, 1.0), (0.9, 0.8), (0.8, 0.7), (0.7, 20.0),
              (float("nan"), 0.6), (0.6, 0.55), (0.5, math.inf),
              (0.5, 0.5), (0.4, 0.45), (0.4, 0.44), (0.3, 0.43), (0.3, 9.0)]
    j, t = JGuard(5.0, window=3, max_events=3), TGuard(5.0, window=3,
                                                        max_events=3)
    exhausted = False
    for epoch, (tr, va) in enumerate(losses, 1):
        rj, rt = j.check(tr, va), t.check(tr, va)
        assert rt == rj
        if rj is not None:
            try:
                j.record_event(epoch, rj)
            except RuntimeError as e:
                with pytest.raises(RuntimeError) as got:
                    t.record_event(epoch, rt)
                assert str(got.value) == str(e)
                exhausted = True
                break
            t.record_event(epoch, rt)
        assert t.state_dict() == j.state_dict()
    assert exhausted
    fresh = TGuard()
    fresh.load_state_dict(j.state_dict())
    assert fresh.state_dict() == j.state_dict()
    with pytest.raises(ValueError):
        TGuard(1.0)
