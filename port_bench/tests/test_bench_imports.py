"""Nothing under port_bench imports jax, jaxlib, flax or the JAX package
(compared by the whole top-level name: the port's name begins with the
JAX package's), and the plain reference imports nothing of the port
either. A run on the CPU leaves none of them in ``sys.modules``."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "unet_convlstm_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_jax_anywhere_in_the_benchmark():
    bad = [(str(p.relative_to(ROOT)), n) for p in BENCH.rglob("*.py")
           for n in _imports(p) if n in FORBIDDEN]
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_port():
    bad = [(str(p.relative_to(ROOT)), n)
           for p in (BENCH / "reference").rglob("*.py")
           for n in _imports(p)
           if n in FORBIDDEN | {"unet_convlstm_tpu_torch"}]
    assert not bad, bad


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        "from port_bench.harness import run_cell\n"
        "from port_bench.run import forbidden_modules\n"
        "from port_bench.tests.tiny import overrides\n"
        "run_cell('custom_b64.serve_streams8', 1, 0.3, False, device='cpu',"
        " overrides=overrides('custom_b64'))\n"
        "print('LOADED', forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
