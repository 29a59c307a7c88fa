"""The yardstick: the card's peaks, each hand-written kernel's operations
and bytes per launch, the launches one step or one request makes, and the
model FLOPs behind ``mfu``. Computed from the cell's shapes alone: the
model family's (``reference/<type>.py``: its ConvLSTM cells, its convs on
K2 and all its convs).

Frozen copies of the bound arithmetic of ``chip_smoke.py`` as it stood when
this benchmark was written (each function names its source line); the
benchmark reads nothing from there.

A launch's bound is the larger of its operations over the peak rate and its
bytes over the peak bandwidth, each input byte read once and each output
byte written once.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from .reference import family

# chip_smoke.py:335-336: NVIDIA's H100 SXM data sheet, dense, no sparsity
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


class Launch(NamedTuple):
    kernel: str        # "k1" (gate update, forward or backward) or "k2"
    ops: float
    nbytes: float

    @property
    def bound_s(self) -> float:
        return max(self.ops / BF16_OPS_PER_S, self.nbytes / HBM_BYTES_PER_S)


def k1_fwd(rows: int, C: int) -> Launch:
    """The gate update's forward (chip_smoke.py:620): bf16 gates [rows, 4C]
    and f32 c in, bf16 h and f32 c' out."""
    return Launch("k1", 0.0, rows * C * (4 * 2 + 4 + 2 + 4))


def k1_bwd(rows: int, C: int, dc_in: bool = True) -> Launch:
    """The gate update's backward (chip_smoke.py:734): gates, c, dh and the
    incoming dc read, dgates and dc written. Without an incoming dc (the
    last step, whose cell no loss reads) its 4 bytes are not read."""
    return Launch("k1", 0.0, rows * C * (2 * 4 * 2 + 4 + 2 + (4 if dc_in
                                                               else 0) + 4))


def k2(n: int, h: int, w: int, cin: int, cout: int,
       prologue: bool) -> Launch:
    """The fused 3x3 conv (chip_smoke.py:841-856): bf16 x, weight and y,
    f32 bias, the prologue's (inv, shift) when there is one, and the two
    f32 sums it always writes; 2*M*9*Cin*Cout operations."""
    m = n * h * w
    nbytes = 2 * (m * cin + 9 * cin * cout + m * cout) \
        + 4 * (cout + (2 * cin if prologue else 0) + 2 * cout)
    return Launch("k2", 2.0 * m * 9 * cin * cout, nbytes)


def launches(m: dict, B: int, T: int, H: int, W: int,
             train: bool) -> List[Launch]:
    """Every K1 and K2 launch of one training step (forward and backward)
    or one request (forward) of B sequences of T frames."""
    fam = family(m)
    out = [k2(B * T, h, w, cin, cout, pro)
           for h, w, cin, cout, pro in fam.k2_convs(m, H, W)]
    for h, w, c in fam.lstm_cells(m, H, W):
        rows = B * h * w
        out += [k1_fwd(rows, c)] * T
        if train:
            out += [k1_bwd(rows, c, dc_in=t < T - 1) for t in range(T)]
    return out


def launch_counts(m: dict, B: int, T: int, H: int, W: int,
                  train: bool) -> Dict[str, int]:
    """The port's counters (``ops.kernels.launch_counts``) one step or
    request should advance: the gate update's forward and backward, and
    the fused conv's calls."""
    fam = family(m)
    cells = fam.lstm_cells(m, H, W)
    return {"gate_update": len(cells) * T,
            "gate_update_bwd": len(cells) * T if train else 0,
            "conv3x3_fused": len(fam.k2_convs(m, H, W))}


# ---------------------------------------------------------------------------
# Model FLOPs (mfu): every convolution, the transposed ones and the gate
# convs included; the backward's weight gradient where the weight trains
# and its input gradient where the input needs one; nothing recomputed.
# ---------------------------------------------------------------------------

class Conv(NamedTuple):
    """One convolution of the model: its forward runs on ``n`` rows
    (frames), its weight gradient on ``dw`` rows and its input gradient on
    ``dx`` rows (0: not needed)."""
    n: int
    h: int          # output height
    w: int          # output width
    cin: int
    cout: int
    k: int
    dw: int
    dx: int


def conv(n, h, w, cin, cout, k, dw=True, dx=True) -> Conv:
    return Conv(n, h, w, cin, cout, k, n if dw else 0, n if dx else 0)


def gate_convs(B, T, h, w, cin, hidden, x_grad: bool) -> List[Conv]:
    """A ConvLSTM layer's gate conv over concat(x, h) as its two input
    halves: the x half on all T frames; the h half runs on T steps but
    its weight and input take a gradient from the second step on (the
    first step's h is the zero state)."""
    return [conv(B * T, h, w, cin, 4 * hidden, 3, True, x_grad),
            Conv(B * T, h, w, hidden, 4 * hidden, 3, B * (T - 1),
                 B * (T - 1))]


def model_flops(m: dict, B: int, T: int, H: int, W: int,
                train: bool) -> float:
    """FLOPs (2 per multiply-add) of one training step (forward, weight
    and input gradients) or of one forward."""
    total = 0.0
    for c in family(m).convs(m, B, T, H, W):
        per_row = 2.0 * c.h * c.w * c.cin * c.cout * c.k * c.k
        total += per_row * (c.n + ((c.dw + c.dx) if train else 0))
    return total
