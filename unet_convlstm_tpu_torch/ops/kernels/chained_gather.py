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
bit. The kernel stages each line with every position's next index beside
its value, so that a link is one shared-memory load; ``plan`` lays out its
launch from the shape alone. A wrapper runs the plain version for tensors
on the CPU; on the card it launches the kernel or raises. It counts its
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import build

# kernel launches since the last ops.kernels.reset_launches()
launches = 0

_SMEM_BYTES = 227 * 1024   # shared memory one block may hold (H100)
_SMEM_PER_SM = 228 * 1024  # shared memory of one SM, 1 KB of it per block
SMS = 132                  # an H100 SXM's streaming multiprocessors
TILE = 16                  # lines a block stages together (a half-warp)
STAGE_PER_THREAD = 16      # line elements a thread stages, where it can
MAX_THREADS = 512          # the kernel's __launch_bounds__(512, 2)
REGS = 64                  # registers a thread takes at most, by the same
MIN_CHAINS = 128           # chains a block runs, at least


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs on the card. The lines along the gathered axis are
    cut into tiles of ``lines`` lines (a power of two); ``splits`` blocks
    stage each tile and run ``chunk`` of its chains each (the last block of
    a tile the rest; a last tile of fewer lines leaves its later blocks
    idle), ``blocks`` = tiles * splits in all, on ``threads`` threads.
    ``pair``: x sits beside next in shared memory (8 bytes an element), else
    next alone (4 bytes) and x is read through L1."""
    lines: int
    splits: int
    chunk: int
    threads: int
    pair: bool
    smem_bytes: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round32(v: int) -> int:
    return _cdiv(v, 32) * 32


@functools.lru_cache(maxsize=256)    # a pure function of a few ints
def plan(R: int, L: int, axis: int, pair: Optional[bool] = None,
         lines: Optional[int] = None, splits: Optional[int] = None) -> Plan:
    """The launch for x [R, L] gathered along ``axis``. Raises where one
    line of 4 (n + 1) bytes does not fit in a block's shared memory.

    A tile is TILE lines (rows for axis 1, neighbouring columns for axis
    0) where there are that many and shared memory holds them, else the
    most lines, a power of two, that it holds, or one line where there are
    fewer than TILE. x sits beside next wherever a line of 8 bytes an
    element fits. Fewer tiles than SMs are split over more blocks, about
    one an SM, as far as each block keeps MIN_CHAINS chains. A block has a
    thread for each of its chains and one for every STAGE_PER_THREAD
    elements it stages, whichever is more, within MAX_THREADS; the blocks
    fit on the SMs at once.

    ``pair``, ``lines`` and ``splits`` fix those choices instead (the
    card's comparison of the alternatives, ``probes.kernel_ab``)."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    n, nlines = (R, L) if axis == 0 else (L, R)
    if 4 * (n + 1) > _SMEM_BYTES:
        raise ValueError(f"chained_gather: a line of {n} values does not "
                         "fit in one block's shared memory")
    fits_pair = 8 * n <= _SMEM_BYTES
    if pair is None:
        pair = fits_pair
    elif pair and not fits_pair:
        raise ValueError(f"chained_gather: a line of {n} values does not "
                         "fit beside its next indices")
    per_line = (8 if pair else 4) * n
    if lines is None:
        # a half-warp's 16 chains in 16 lines: conflict-free links; fewer
        # lines than that would only make each block stage more
        most = min(TILE if nlines >= TILE else 1,
                   _SMEM_BYTES // max(per_line, 1))
        lines = 1 << (max(most, 1).bit_length() - 1)
    elif lines < 1 or lines & (lines - 1) or lines * per_line > _SMEM_BYTES:
        raise ValueError(f"chained_gather: no tile of {lines} lines of {n}")
    count = lines * n                       # elements (chains) of a tile
    tiles = _cdiv(nlines, lines)
    smem = lines * per_line

    def threads_for(splits):
        return min(MAX_THREADS, max(32, _round32(max(
            _cdiv(count, STAGE_PER_THREAD), _cdiv(count, splits)))))

    if splits is None:
        splits = max(1, min(SMS // max(tiles, 1), _cdiv(count, MIN_CHAINS)))
        threads = threads_for(splits)
        # blocks an SM holds at once: threads, blocks, registers, shared
        # memory
        resident = min(2048 // threads, 32, 65536 // (threads * REGS),
                       _SMEM_PER_SM // (smem + 1024))
        splits = max(1, min(splits, SMS * resident // max(tiles, 1)))
    chunk = max(1, _cdiv(count, splits))
    splits = _cdiv(count, chunk) if count else 1
    return Plan(lines, splits, chunk, threads_for(splits), pair, smem,
                tiles * splits)


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


def _lib(lib: Optional[ctypes.CDLL] = None) -> ctypes.CDLL:
    """The built ``csrc/chained_gather.cu``, or ``lib`` (a variant of it),
    with its entry points' signatures."""
    lib = lib or build.load("chained_gather")
    if lib.chained_gather.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.chained_gather.restype = I
        lib.chained_gather.argtypes = [P, P, P] + [I] * 11 + [P]
        lib.chained_gather_latency_floor.restype = I
        lib.chained_gather_latency_floor.argtypes = [P, I, P]
    return lib


def latency_floor(reps: int, out: torch.Tensor) -> torch.Tensor:
    """Launch the one-block chase beside K7 (``reps`` dependent shared
    loads a lane) into ``out`` int32 [32] on the card: the least time a
    chain of ``reps`` links takes, launch included. It is a yardstick and
    counts no launch of K7."""
    if out.device.type != "cuda" or out.dtype != torch.int32 \
            or out.numel() < 32:
        raise ValueError("latency_floor: out must be int32 [32] on a card")
    rc = _lib().chained_gather_latency_floor(
        out.data_ptr(), int(reps),
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chained_gather_latency_floor launch failed: "
                           f"CUDA error {rc}")
    return out


def chained_gather(x: torch.Tensor, idx: torch.Tensor, axis: int,
                   reps: int) -> torch.Tensor:
    """acc after ``reps`` chained gathers along ``axis``. On the CPU: the
    plain version. On the card: the CUDA kernel."""
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
    return _launch(x, idx, axis, reps, plan(x.shape[0], x.shape[1], axis))


def _launch(x: torch.Tensor, idx: torch.Tensor, axis: int, reps: int,
            p: Plan, lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Launch K7 (or a variant's build, ``lib``) on checked tensors with the
    plan ``p``."""
    global launches
    out = torch.empty_like(x)
    rc = _lib(lib).chained_gather(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        axis, int(reps), p.lines, p.splits, p.chunk, p.blocks, p.threads,
        int(p.pair), p.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"chained_gather launch failed: CUDA error {rc}")
    return out
