"""Build and load the host kernels of ``hostio.cpp`` (counterpart of
unet_convlstm_tpu/native/build.py).

``g++ -O3 -shared -fPIC -std=c++17 -pthread`` compiles the source at first
use into ``_build/host-<hash>/libhostio.so`` beside the package, where the
hash covers the source and the flags: an edited source is rebuilt, an
unchanged one is reused, and a library built from another source is never
loaded. The compiler writes a temporary file that one ``os.replace`` puts
in place, so processes building at once never load half a file. No
``-march=native``: a library built on one host runs on another.

Unlike the JAX package's ``load_hostio``, which returns None and lets its
callers fall back to numpy, a failed build raises with the compiler's
stderr: a quiet fallback would hide a broken toolchain behind a slower
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().with_name("hostio.cpp")
BUILD_ROOT = SOURCE.parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the compiler took when this process built the library; None when
# it was found built
built_in_s: Optional[float] = None


def build_dir(src: Path = SOURCE, root: Path = BUILD_ROOT) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(Path(src).read_bytes())
    return Path(root) / f"host-{h.hexdigest()[:16]}"


def build(src: Path = SOURCE, root: Path = BUILD_ROOT, cxx: str = CXX
          ) -> Path:
    """The library built from ``src`` (compiled first when ``build_dir``
    has none). Raises ``RuntimeError`` with the compiler's stderr when the
    compiler cannot be run or fails."""
    global built_in_s
    out = build_dir(src, root) / "libhostio.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"hostio: cannot run {cxx!r}: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"hostio: {cxx} {Path(src).name} exited "
                           f"{r.returncode}:\n{r.stderr}")
    os.replace(tmp, out)
    built_in_s = time.perf_counter() - t0
    return out


def load_hostio() -> ctypes.CDLL:
    """The host kernels, built at the first call of the process and bound
    with their argument types."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            lib.gather_transpose_f32.argtypes = [ptr, ptr, ptr, i64, i64,
                                                 i64, i64, i64,
                                                 ctypes.c_int32]
            lib.gather_transpose_f32.restype = None
            lib.paste_digit_f32.argtypes = [ptr, ptr, ptr, i64, i64, i64,
                                            ctypes.c_float]
            lib.paste_digit_f32.restype = None
            _lib = lib
        return _lib
