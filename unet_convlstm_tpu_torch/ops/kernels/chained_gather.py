"""A chain of dependent gathers inside one block: a CUDA kernel and its plain
PyTorch version (counterpart of the TPU kernel ``gather_kernel``,
scripts/perf/probe_pallas_gather.py:33, the gather-throughput probe).

``chained_gather(x, idx, axis, reps)``: x f32 [R, L], idx int32 [R, L] with
every index in [0, x.shape[axis]), axis 0 or 1 → acc f32 [R, L] after
``reps`` links of

    v = take_along_axis(x, idx, axis); acc += v
    idx = (idx + int32(v) + 1) mod n,  n = x.shape[axis]

``int32(v)`` truncates toward zero, the int32 add wraps, and ``mod`` is the
floor modulo of jnp's ``%`` (never negative). ``acc`` adds in link order, so
the kernel (``csrc/chained_gather.cu``) and the plain version agree bit for
bit. A wrapper runs the plain version for tensors on the CPU; on the card it
launches the kernel or raises. It counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# kernel launches since the last ops.kernels.reset_launches()
launches = 0

_SMEM_BYTES = 227 * 1024   # shared memory one block may hold (H100)


def chained_gather_plain(x: torch.Tensor, idx: torch.Tensor, axis: int,
                         reps: int) -> torch.Tensor:
    """The same chain in plain PyTorch, one ``torch.gather`` a link."""
    n = x.shape[axis]
    acc = torch.zeros_like(x)
    idx = idx.to(torch.int32)
    for _ in range(reps):
        v = torch.gather(x, axis, idx.long())
        acc = acc + v
        idx = torch.remainder(idx + v.to(torch.int32) + 1, n)
    return acc


def _lib():
    fn = build.load("chained_gather").chained_gather
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, I, P]
    return fn


def chained_gather(x: torch.Tensor, idx: torch.Tensor, axis: int,
                   reps: int) -> torch.Tensor:
    """acc after ``reps`` chained gathers along ``axis``. On the CPU: the
    plain version. On the card: the CUDA kernel."""
    global launches
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return chained_gather_plain(x, idx, axis, reps)
    if x.device.type != "cuda" or idx.device != x.device:
        raise ValueError("chained_gather: x and idx must be on one CUDA "
                         "device")
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("chained_gather takes f32 values and int32 indices, "
                        f"got {x.dtype} and {idx.dtype}")
    if x.dim() != 2 or idx.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} must be [R, L] and idx the "
                         f"same shape, got {tuple(idx.shape)}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("chained_gather needs contiguous tensors")
    if 4 * (x.shape[axis] + 1) > _SMEM_BYTES:
        raise ValueError(f"chained_gather: a line of {x.shape[axis]} values "
                         "does not fit in one block's shared memory")
    out = torch.empty_like(x)
    rc = _lib()(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
                x.shape[1], axis, int(reps),
                torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"chained_gather launch failed: CUDA error {rc}")
    return out
