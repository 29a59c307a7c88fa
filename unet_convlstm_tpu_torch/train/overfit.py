"""Overfit harness: the reference's convergence sanity gate (counterpart of
unet_convlstm_tpu/train/overfit.py).

Pick ``num_samples`` random sequences (``default_rng(seed).choice``), one
fixed batch, AdamW(1e-3, wd 1e-4) with no effective clip, and iterate the
masked MSE (``sum(diff²·mask) / (sum(mask) + 1e-6)``) up to ``max_iters``
steps; success when the loss drops below ``target_loss``. Steps run in
chunks of ``chunk`` with the loss read on the host between chunks (never
past ``max_iters``). The checkpoint carries the selected indices so the run
can be replayed. The model runs the hand-written kernels on the card.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.dtypes import resolve_device
from ..data.npz_dataset import NPZSequenceDataset
from ..models.registry import build_model, commit_bn_stats
from ..ops.losses import masked_mse
from ..ops.normalize import compute_mask, normalize_x, normalize_y
from .checkpoint import save_checkpoint
from .loop import _trainable_mask
from .optim import make_optimizer


def run_overfit_test(npz_path_or_ds, model_cfg: Optional[Dict[str, Any]] = None,
                     num_samples: int = 16, max_iters: int = 3001,
                     target_loss: float = 5e-4, lr: float = 1e-3,
                     weight_decay: float = 1e-4, chunk: int = 100,
                     seed: int = 0, use_all_ones_mask: Optional[bool] = None,
                     checkpoint_dir: Optional[str] = None,
                     verbose: bool = True, device=None) -> Dict[str, Any]:
    """Returns {'converged', 'final_loss', 'iters', 'indices', 'losses'
    (the loss at the end of each chunk), 'model'}."""
    log = print if verbose else (lambda *a, **k: None)
    dev = resolve_device(device)
    ds = (npz_path_or_ds if isinstance(npz_path_or_ds, NPZSequenceDataset)
          else NPZSequenceDataset(npz_path_or_ds))
    model_cfg = model_cfg or {"type": "custom", "base_ch": 64,
                              "use_skip_lstm": True, "use_attention": False}

    rng = np.random.default_rng(seed)
    indices = rng.choice(len(ds), size=min(num_samples, len(ds)),
                         replace=False)
    x_np, y_np = ds.get_batch_raw(np.sort(indices))
    x_raw = torch.from_numpy(x_np).to(dev)
    s = ds.stats
    x = normalize_x(x_raw, s)
    y = normalize_y(torch.from_numpy(y_np).to(dev), s)
    mask = compute_mask(x_raw, s)
    if use_all_ones_mask is None:
        # Moving-MNIST intensities never exceed the 1.1 radiance threshold:
        # an all-zero mask makes the gate vacuous, so fall back to ones
        use_all_ones_mask = float(mask.sum()) == 0.0
    if use_all_ones_mask:
        mask = torch.ones_like(mask)

    _, init_fn, apply_fn, _ = build_model(model_cfg)
    apply_fn = functools.partial(apply_fn, use_pallas=True,
                                 use_fused_doubleconv=True)
    model = init_fn(torch.Generator().manual_seed(seed), device=dev)
    opt = make_optimizer(model.named_parameters(), lr, weight_decay,
                         grad_clip=1e9,
                         trainable_mask=_trainable_mask(model, model_cfg))

    def one_step() -> torch.Tensor:
        opt.zero_grad()
        y_pred, _, new_bn = apply_fn(model, x, train=True)
        loss = masked_mse(y_pred, y, mask)
        loss.backward()
        opt.step()
        commit_bn_stats(model, new_bn)
        return loss.detach()

    iters_done, final_loss, converged, chunk_losses = 0, float("inf"), \
        False, []
    while iters_done < max_iters:
        length = min(chunk, max_iters - iters_done)  # never overshoot
        for _ in range(length):
            loss = one_step()
        iters_done += length
        final_loss = float(loss)                     # one read per chunk
        chunk_losses.append(final_loss)
        log(f"iter {iters_done:04d} | loss {final_loss:.6f}")
        if final_loss < target_loss:
            converged = True
            break

    if checkpoint_dir:
        tag = "overfit" if converged else "overfit_failed"
        save_checkpoint(
            os.path.join(checkpoint_dir,
                         f"{tag}_{model_cfg.get('type', 'custom')}.pt"),
            model.state_dict(), model_cfg, s.to_dict(),
            optimizer=opt.state_dict(), indices=indices.tolist(),
            final_loss=final_loss, iters=iters_done)
    return {"converged": converged, "final_loss": final_loss,
            "iters": iters_done, "indices": indices, "losses": chunk_losses,
            "model": model}
