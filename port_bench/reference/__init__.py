"""The plain float32 references that decide ``correct``; they import
nothing of the port. A model family's reference (and the shapes the
yardstick counts) is ``reference/<type>.py``, found by the configuration's
``model.type``: a later family is a new file."""

from __future__ import annotations

import importlib
from typing import Dict

import torch


def family(m: dict):
    """The module of the model family ``m["type"]``."""
    return importlib.import_module(f"{__name__}.{m['type']}")


@torch.no_grad()
def calibrate_bn(P: Dict[str, torch.Tensor], m: dict,
                 x_seq) -> Dict[str, torch.Tensor]:
    """Running statistics that normalize the activations of ``x_seq`` [B,
    T, C, H, W]: one train-mode pass in which every BatchNorm takes its
    batch's statistics and records them whole (momentum 1), as a trained
    model's would roughly be."""
    return family(m).forward(P, m, x_seq, None, True, None, momentum=1.0)[2]
