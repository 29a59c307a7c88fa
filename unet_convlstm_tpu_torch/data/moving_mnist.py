"""Moving-MNIST with velocity, on the host (counterpart of
unet_convlstm_tpu/data/moving_mnist.py; this package's own copy).

* ``data[N, T, 2, H, W]`` float32. Channel 0 is the digit intensity in
  [0, 1]; channel 1 the per-pixel horizontal velocity vx, accumulated only
  on digit pixels (overlapping digits add their vx).
* Per sample, ``num_digits`` 28x28 digit crops bounce inside an HxW frame:
  initial position ~ randint(0, H-28+1), velocity ~ randint(-5, 6). Per
  frame: paste (a later digit wins on overlap in channel 0), add vx into
  channel 1 on digit pixels, move, then reflect the velocity and clamp the
  position at the walls.
* RNG: the legacy global ``np.random`` stream, drawn in the reference's
  order — per sample, per digit: ``randint(0, len(digits))``,
  ``randint(0, H-28+1, size=2)`` (x then y), ``randint(-5, 6, size=2)``
  (vx then vy). At a given seed and digit bank the output is byte-identical
  to the JAX package's generator.

Each paste runs natively (``paste_digit``: ``paste_digit_f32`` of
native/hostio.cpp, as in the JAX generator); ``paste_digit_plain`` is its
numpy version and reference.

``load_mnist_digits`` finds an on-disk MNIST copy when there is one;
``synthetic_digit_bank`` is a deterministic glyph-based stand-in with the
same contract (uint8 [M, 28, 28]). Nothing is downloaded.
"""

from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

# 8x8 bitmap glyphs for digits 0-9 (classic 8x8 font rows, MSB left).
_FONT8 = {
    0: [0x3C, 0x66, 0x6E, 0x76, 0x66, 0x66, 0x3C, 0x00],
    1: [0x18, 0x38, 0x18, 0x18, 0x18, 0x18, 0x7E, 0x00],
    2: [0x3C, 0x66, 0x06, 0x1C, 0x30, 0x66, 0x7E, 0x00],
    3: [0x3C, 0x66, 0x06, 0x1C, 0x06, 0x66, 0x3C, 0x00],
    4: [0x0E, 0x1E, 0x36, 0x66, 0x7F, 0x06, 0x06, 0x00],
    5: [0x7E, 0x60, 0x7C, 0x06, 0x06, 0x66, 0x3C, 0x00],
    6: [0x1C, 0x30, 0x60, 0x7C, 0x66, 0x66, 0x3C, 0x00],
    7: [0x7E, 0x66, 0x06, 0x0C, 0x18, 0x18, 0x18, 0x00],
    8: [0x3C, 0x66, 0x66, 0x3C, 0x66, 0x66, 0x3C, 0x00],
    9: [0x3C, 0x66, 0x66, 0x3E, 0x06, 0x0C, 0x38, 0x00],
}


def synthetic_digit_bank(num_per_class: int = 10, size: int = 28) -> np.ndarray:
    """Deterministic MNIST stand-in: 8x8 font glyphs upscaled to 28x28 with
    small per-instance intensity jitter (seeded). uint8 [10*num_per_class,
    28, 28] — the same contract as ``mnist.data.numpy()``."""
    rs = np.random.RandomState(1234)
    bank = []
    for d in range(10):
        rows = _FONT8[d]
        glyph = np.zeros((8, 8), np.uint8)
        for r, bits in enumerate(rows):
            for c in range(8):
                if bits & (0x80 >> c):
                    glyph[r, c] = 255
        # nearest-neighbour upscale 8->24, center in 28x28
        up = np.repeat(np.repeat(glyph, 3, axis=0), 3, axis=1)  # 24x24
        canvas = np.zeros((size, size), np.uint8)
        canvas[2:26, 2:26] = up
        for _ in range(num_per_class):
            jitter = rs.randint(180, 256)
            inst = (canvas.astype(np.float32) * (jitter / 255.0))
            bank.append(inst.astype(np.uint8))
    return np.stack(bank)


def load_mnist_digits(root: Optional[str] = None) -> Optional[np.ndarray]:
    """Load raw MNIST train images from an on-disk copy (idx/gz layout used by
    torchvision). Returns uint8 [60000, 28, 28] or None when unavailable."""
    candidates = []
    if root:
        candidates.append(root)
    candidates += [
        os.path.expanduser("~/.cache/mnist"),
        "./data/MNIST/raw",
        "./data",
    ]
    for base in candidates:
        for name in ("train-images-idx3-ubyte.gz", "train-images-idx3-ubyte"):
            path = os.path.join(base, name)
            if not os.path.exists(path):
                path = os.path.join(base, "MNIST", "raw", name)
            if os.path.exists(path):
                opener = gzip.open if path.endswith(".gz") else open
                with opener(path, "rb") as f:
                    buf = f.read()
                magic = int.from_bytes(buf[0:4], "big")
                if magic != 2051:
                    continue
                n = int.from_bytes(buf[4:8], "big")
                return np.frombuffer(buf, np.uint8, offset=16).reshape(n, 28, 28)
    return None


def _simulate_trajectory(x0: int, y0: int, vx0: int, vy0: int, seq_len: int,
                         image_size: int):
    """Positions/vx at paste time for each frame (paste, move, bounce+clamp)."""
    xs = np.empty(seq_len, np.int64)
    ys = np.empty(seq_len, np.int64)
    vxs = np.empty(seq_len, np.int64)
    x, y, vx, vy = x0, y0, vx0, vy0
    hi = image_size - 28
    for t in range(seq_len):
        xs[t], ys[t], vxs[t] = x, y, vx
        x += vx
        y += vy
        if x < 0 or x > hi:
            vx = -vx
            x = min(max(x, 0), hi)
        if y < 0 or y > hi:
            vy = -vy
            y = min(max(y, 0), hi)
    return xs, ys, vxs


def paste_digit_plain(frame: np.ndarray, vel: np.ndarray,
                      digit: np.ndarray, y: int, x: int, vx: float) -> None:
    """One digit into one frame, in numpy: where the digit is > 0 it
    overwrites ``frame`` (a later digit wins) and ``vx`` adds into
    ``vel``. The native paste's reference."""
    mask = digit > 0
    win_s = frame[y:y + 28, x:x + 28]
    win_v = vel[y:y + 28, x:x + 28]
    win_s[mask] = digit[mask]
    win_v[mask] += vx


def paste_digit(frame: np.ndarray, vel: np.ndarray, digit: np.ndarray,
                y: int, x: int, vx: float) -> None:
    """``paste_digit_plain`` in one native pass (``paste_digit_f32`` of
    native/hostio.cpp): frame and vel C-contiguous float32 [S, S], digit
    C-contiguous float32 [28, 28], the window inside the frame."""
    from ..native.build import load_hostio

    S = frame.shape[-1]
    for a, shape in ((frame, (S, S)), (vel, (S, S)), (digit, (28, 28))):
        if (a.shape != shape or a.dtype != np.float32
                or not a.flags["C_CONTIGUOUS"]):
            raise ValueError(f"paste_digit: expected C-contiguous float32 "
                             f"{shape}, got {a.dtype} {a.shape}")
    if not (0 <= y <= S - 28 and 0 <= x <= S - 28):
        raise ValueError(f"paste_digit: window ({y}, {x}) outside the "
                         f"{S}x{S} frame")
    load_hostio().paste_digit_f32(frame.ctypes.data, vel.ctypes.data,
                                  digit.ctypes.data, S, y, x, vx)


def generate_moving_mnist(seq_len: int = 10, num_samples: int = 1000,
                          image_size: int = 64, num_digits: int = 2,
                          digits: Optional[np.ndarray] = None,
                          seed: Optional[int] = None) -> np.ndarray:
    """Generate ``[num_samples, seq_len, 2, H, W]`` float32 sequences.

    ``digits``: uint8 [M, 28, 28] bank (MNIST when available). ``seed`` seeds
    the legacy global np.random stream (the reference leaves it unseeded);
    pass None to consume the current global state exactly like the reference.
    """
    if digits is None:
        digits = load_mnist_digits()
        if digits is None:
            digits = synthetic_digit_bank()
    if seed is not None:
        np.random.seed(seed)

    H = image_size
    data = np.zeros((num_samples, seq_len, 2, H, H), np.float32)

    for i in range(num_samples):
        seq = np.zeros((seq_len, H, H), np.float32)
        vel = np.zeros((seq_len, H, H), np.float32)
        for _ in range(num_digits):
            # RNG consumption order matches the reference exactly.
            digit = digits[np.random.randint(0, len(digits))]
            x0, y0 = np.random.randint(0, H - 28 + 1, size=2)
            vx0, vy0 = np.random.randint(-5, 6, size=2)

            digit_norm = np.ascontiguousarray(
                digit.astype(np.float32) / 255.0)

            xs, ys, vxs = _simulate_trajectory(
                int(x0), int(y0), int(vx0), int(vy0), seq_len, H)
            for t in range(seq_len):
                paste_digit(seq[t], vel[t], digit_norm, int(ys[t]),
                            int(xs[t]), float(vxs[t]))
        data[i, :, 0] = seq
        data[i, :, 1] = vel
    return data


def moving_mnist_to_xy(data: np.ndarray):
    """Convert generator output to the training (X, Y) contract.

    X [N,T,2,H,W]: the digit-intensity frame duplicated into both input
    channels — the Moving-MNIST analog of the two satellite views (the cloud
    dataset packs view-0/view-1 renders there, reference
    preprocessing/build_sequences.py:149-151). Y [N,T,1,H,W]: the per-pixel
    vx map (the velocity-field target, analog of the W map).
    """
    frames = data[:, :, 0:1]
    X = np.concatenate([frames, frames], axis=2).astype(np.float32)
    Y = data[:, :, 1:2].astype(np.float32)
    return X, Y


def save_moving_mnist_npz(path: str, seq_len: int = 40,
                          num_samples: int = 10000, image_size: int = 64,
                          num_digits: int = 2, seed: Optional[int] = 0,
                          as_xy: bool = False) -> str:
    """Write the dataset npz. ``as_xy=False`` writes the reference's layout
    (key 'data', digits/build_moving_mnist.py:66); ``as_xy=True`` writes the
    trainer's X/Y layout."""
    data = generate_moving_mnist(seq_len, num_samples, image_size, num_digits,
                                 seed=seed)
    if as_xy:
        X, Y = moving_mnist_to_xy(data)
        np.savez_compressed(path, X=X, Y=Y)
    else:
        np.savez_compressed(path, data=data)
    return path
