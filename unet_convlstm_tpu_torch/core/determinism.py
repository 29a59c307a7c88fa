"""Deterministic library kernels for a training run.

The JAX package needs no switch: XLA on the TPU gives the same bits on every
run, and its cloud gate is "the reproducible version" of the golden run.
On the card, cuDNN may pick its algorithms by timing them and some of them
(and some of torch's own CUDA kernels) add in an order that varies from run
to run. ``deterministic(device)`` turns that off for the run it wraps:

* ``torch.backends.cudnn.deterministic = True`` and ``.benchmark = False``;
* ``torch.use_deterministic_algorithms(True)``: an op torch knows has no
  deterministic CUDA kernel raises instead of running. Its side effect,
  filling every new ``torch.empty`` with NaN
  (``torch.utils.deterministic.fill_uninitialized_memory``), is turned off
  inside the block: it makes no result reproducible (the code reads no
  uninitialized memory; the kernels write every element they return) and
  costs one more launch an allocation;
* cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8``) before its first
  handle: the CLI and ``chip_smoke.py`` set it before CUDA starts; inside
  the context it is set if CUDA has not started yet, and otherwise its
  absence raises.

The flags are restored on exit. The hand-written kernels are outside
torch's check: they add in fixed orders themselves (no float atomics in
``csrc/``).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.utils.deterministic

CUBLAS_WORKSPACE_CONFIG = ":4096:8"
_CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


def set_cublas_workspace_config() -> None:
    """Set ``CUBLAS_WORKSPACE_CONFIG`` for cuBLAS's deterministic mode unless
    the caller set it; call before CUDA starts."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)


def _check_cublas() -> None:
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") in _CUBLAS_DETERMINISTIC:
        return
    if torch.cuda.is_initialized():
        raise RuntimeError(
            "deterministic training on the card needs CUBLAS_WORKSPACE_CONFIG"
            f"={CUBLAS_WORKSPACE_CONFIG} before CUDA starts (cuBLAS reads it "
            "at its first handle), and CUDA has started without it: set it in "
            "the environment, or call core.determinism."
            "set_cublas_workspace_config() first")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE_CONFIG


@contextlib.contextmanager
def deterministic(device=None):
    """Deterministic cuDNN and torch kernels inside the block, the previous
    settings restored after. ``device``: where the run computes (the cuBLAS
    check applies to a CUDA device only)."""
    if device is not None and torch.device(device).type == "cuda":
        _check_cublas()
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = prev[4]
        torch.backends.cudnn.deterministic = prev[2]
        torch.backends.cudnn.benchmark = prev[3]
