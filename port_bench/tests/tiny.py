"""The tiny sizes the CPU tests run each cell at (the widths cut, so that
a run takes seconds on one core)."""

TINY = {"custom_b64": {"model": {"base_ch": 4}, "image": [32, 32],
                       "seq_len": 3}}
TRAFFIC = {"batch": 2, "pool": 8, "sessions": 2, "seq_frames": 3,
           "rate_rps": 20.0, "trace_seconds": 0.5}


def overrides(config: str) -> dict:
    return {"config": TINY[config], "traffic": TRAFFIC}


def fp32_hooks(kind: str) -> dict:
    """The port in float32 (its FP32 policy): the training step's, or the
    served predictor's."""
    from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY

    if kind == "train":
        return {"policy": FP32_POLICY}

    def predictor(pred):
        pred.policy = FP32_POLICY
        return pred
    return {"predictor": predictor}
