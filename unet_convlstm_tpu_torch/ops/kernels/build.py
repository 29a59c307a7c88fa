"""Build the package's CUDA kernels from ``csrc/*.cu`` at first use.

Each source compiles on its own into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``), all sources in parallel, and is loaded with
``ctypes``. Libraries land in ``_build/<hash>/`` beside the package, where
the hash covers every source and the compiler flags, so an edited source
is rebuilt and an unchanged one is reused. Nothing is imported or compiled
when this module is imported: the first ``load`` does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel library name → its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in sources().items():
        h.update(name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def build_all() -> Dict[str, float]:
    """Compile every source that has no library yet in ``build_dir()``.

    One ``nvcc`` per source, all started together. Returns the seconds
    each build took (empty when everything was built already); raises
    with nvcc's stderr when one fails. ptxas's register and spill report
    is kept in ``<name>.log`` beside each library."""
    out = build_dir()
    todo = {n: p for n, p in sources().items()
            if not (out / f"lib{n}.so").exists()}
    if not todo:
        return {}
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, src in todo.items():
        tmp = out / f"lib{name}.so.tmp{os.getpid()}"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (out / f"{name}.log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {todo[name].name} (exit "
                          f"{proc.returncode}) ---\n{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load_variant(name: str, edits) -> ctypes.CDLL:
    """A library built from ``csrc/<name>.cu`` with ``edits`` applied, each
    (old, new) replacing text that occurs exactly once: an alternative
    design timed against the shipped one (``probes.kernel_ab``). Built in
    ``_build/variants/<hash>/`` with the same flags, its ptxas report in
    ``<name>.log`` beside it."""
    text = sources()[name].read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"csrc/{name}.cu: {old!r} occurs "
                             f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + text).encode())
    out = BUILD_ROOT / "variants" / h.hexdigest()[:16]
    lib = out / f"lib{name}.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{name}.cu").write_text(text)
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                            str(out / f"{name}.cu")],
                           capture_output=True, text=True)
        (out / f"{name}.log").write_text(r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc of a variant of {name}.cu failed:\n"
                               f"{r.stderr}")
    return ctypes.CDLL(str(lib))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name not in sources():
                raise KeyError(f"no kernel source csrc/{name}.cu")
            build_all()
            lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            _libs[name] = lib
        return lib
