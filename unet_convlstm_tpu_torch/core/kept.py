"""Values derived from weights (a BatchNorm's inference affine, a weight
cast to the compute dtype), computed once per set of weights while
gradients are off, as in serving and in a frozen encoder's forward.

``kept(owner, key, tensors, compute)`` returns ``compute()``, kept for
``owner`` under ``key`` while each of ``tensors`` is the same object at the
same version and address: an in-place write (an optimizer step, committed
running statistics, ``load_state_dict``), a new tensor in a module's slot
or a move (``.to``, a new ``.data``) computes it afresh. With gradients
on, or an inference tensor among ``tensors`` (whose version is not
tracked), it is computed on every call, so that the graph reaches the
weights. A value made in inference mode is kept apart from one made
outside it. Nothing here holds ``owner`` or ``tensors`` alive.
"""

from __future__ import annotations

import weakref
from typing import Callable, Hashable, Sequence, TypeVar

import torch
from torch.utils.weak import WeakIdKeyDictionary

V = TypeVar("V")

# owner -> {(key, inference mode): (stamps, weakrefs to tensors, value)}
_KEPT = WeakIdKeyDictionary()


def kept(owner: object, key: Hashable, tensors: Sequence[torch.Tensor],
         compute: Callable[[], V]) -> V:
    """``compute()``, computed once per set of ``tensors`` (the module's
    docstring)."""
    if torch.is_grad_enabled() or any(t.is_inference() for t in tensors):
        return compute()
    stamps = tuple((t._version, t.data_ptr()) for t in tensors)
    held = _KEPT.get(owner)
    if held is None:
        held = _KEPT[owner] = {}
    key = (key, torch.is_inference_mode_enabled())
    hit = held.get(key)
    if (hit is not None and hit[0] == stamps
            and all(r() is t for r, t in zip(hit[1], tensors))):
        return hit[2]
    value = compute()
    held[key] = (stamps, tuple(weakref.ref(t) for t in tensors), value)
    return value
