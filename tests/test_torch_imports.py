"""The port stands alone: unet_convlstm_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, not even a module of it without JAX."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "unet_convlstm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "unet_convlstm_tpu")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_sources_have_no_jax_imports():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


BLOCKED_IMPORT = r"""
import pkgutil, sys
for name in list(sys.modules):
    if name.split(".")[0] in {forbidden!r}:
        del sys.modules[name]
for name in {forbidden!r}:
    sys.modules[name] = None       # any import of it now raises ImportError
import unet_convlstm_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    __import__(m)
sys.path.insert(0, {root!r})
import chip_smoke
print(" ".join(mods))
"""
# the subpackages of every slice so far, each imported with jax blocked
COVERED = ("ops.kernels.convlstm_fused", "serve", "train.steps",
           "datagen.mc_reference", "ops.kernels.channel_stats",
           "ops.kernels.chained_gather", "probes.bn_kernel_proto",
           "probes.probe_gather", "data.npz_dataset", "data.pipeline",
           "data.fast_gather", "train.loop", "train.config", "train.guard",
           "train.overfit", "train.checkpoint", "models.resnet_unet",
           "models.registry", "utils.torch_weights", "eval.metrics",
           "eval.rollout", "eval.image_metrics", "viz.geometry",
           "viz.figures", "viz.rollout_video", "ops.quant",
           "ops.kernels.conv_int8")


def test_every_module_imports_with_jax_blocked():
    code = BLOCKED_IMPORT.format(forbidden=FORBIDDEN, root=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    mods = set(r.stdout.split())
    assert len(mods) >= 15, r.stdout
    missing = [m for m in COVERED if f"unet_convlstm_tpu_torch.{m}" not in mods]
    assert not missing, missing
