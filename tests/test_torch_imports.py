"""The port stands alone: unet_convlstm_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, not even a module of it without JAX, and
the native sources it builds are its own. Its subpackages re-export the
JAX subpackages' public names, or map them to a counterpart, or say why
there is none."""

import ast
import importlib
import pathlib
import re
import subprocess
import sys

import pytest

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
           "ops.kernels.conv_int8", "datagen.microphysics",
           "datagen.vol_format", "datagen.lespatch", "ops.resize",
           "datagen.raycast", "datagen.velocity_maps", "datagen.alignment",
           "datagen.sequences", "train.cloud_gate", "native.build",
           "viz.checks", "viz.viewers", "viz.dashboard3d",
           "viz.sequences_video", "viz.legacy_viewer", "viz.optional")


def test_every_module_imports_with_jax_blocked():
    code = BLOCKED_IMPORT.format(forbidden=FORBIDDEN, root=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    mods = set(r.stdout.split())
    assert len(mods) >= 15, r.stdout
    missing = [m for m in COVERED if f"unet_convlstm_tpu_torch.{m}" not in mods]
    assert not missing, missing


def test_native_sources_are_the_ports_own():
    """csrc/*.cu and native/*.cpp lie in the port and include nothing of
    the JAX package; the build modules read them from there."""
    from unet_convlstm_tpu_torch.native import build as host_build
    from unet_convlstm_tpu_torch.ops.kernels import build

    srcs = sorted(PKG.rglob("*.cu")) + sorted(PKG.rglob("*.cpp"))
    assert {p.name for p in srcs} >= {"hostio.cpp", "conv_int8.cu"}
    for path in srcs:
        includes = re.findall(r'#include\s*[<"]([^>"]+)', path.read_text())
        assert not [i for i in includes if "unet_convlstm_tpu" in i
                    or "jax" in i], (path, includes)
    assert host_build.SOURCE.parent == PKG / "native"
    assert all(p.parent == PKG / "csrc" for p in build.sources().values())


# JAX subpackage → the port's counterpart
SUBPACKAGES = {"core": "core", "data": "data", "datagen": "datagen",
               "eval": "eval", "models": "models", "native": "native",
               "ops": "ops", "ops.pallas": "ops.kernels",
               "parallel": None, "train": "train", "utils": "utils",
               "viz": "viz"}
# a re-exported JAX name the port has under another name or place
COUNTERPARTS = {
    # the JAX init functions are the nn.Module classes
    "models.temporal_unet_init": "models.TemporalUNetDualView",
    "models.resnet_unet_init": "models.PretrainedTemporalUNet",
    "ops.conv2d_init": "ops.Conv2d",
    "ops.conv_transpose2d_init": "ops.ConvTranspose2d",
    "ops.batchnorm_init": "torch.nn.BatchNorm2d",
    "ops.double_conv_init": "ops.DoubleConv",
    "ops.down_init": "ops.Down",
    "ops.up_init": "ops.Up",
    "ops.out_conv_init": "ops.OutConv",
    "ops.spatial_attention_init": "ops.SpatialAttention",
    "ops.convlstm_cell_init": "ops.ConvLSTMCell",
    "ops.convlstm_init": "ops.ConvLSTM",
    # re-exported it would hide the module ops.convlstm
    "ops.convlstm": "ops.convlstm.convlstm",
    # the Pallas kernel's wrapper is the CUDA kernel's
    "ops.pallas.fused_gate_update":
        "ops.kernels.convlstm_fused.fused_gate_update",
}
# a re-exported JAX name with no counterpart, and why
NO_COUNTERPART = {
    **{f"core.{n}": "JAX pytree helpers (core/module.py): an nn.Module "
                    "holds its own parameters and buffers"
       for n in ("Variables", "merge", "split_rngs", "tree_size")},
    "utils.enable_persistent_cache": "XLA's compile cache "
                                     "(utils/compile_cache.py); the CUDA "
                                     "kernels build once into _build/",
    "utils.convert_resnet18_state_dict": "the port's encoder takes "
                                         "torchvision's names and layouts "
                                         "as they are (load_torch_resnet18)",
    **{f"parallel.{n}": "multi-device, ROADMAP.md queue A item 7"
       for n in ("make_mesh", "batch_sharding", "replicated_sharding",
                 "shard_batch_spec", "MeshRules")},
}


def _jax_reexports(sub):
    """Names the JAX subpackage's __init__ imports from its modules."""
    path = ROOT / "unet_convlstm_tpu" / sub.replace(".", "/") / "__init__.py"
    return [a.asname or a.name
            for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.ImportFrom) and node.level >= 1
            for a in node.names]


def _resolve(dotted):
    if dotted.startswith("torch."):
        mod, _, name = dotted.rpartition(".")
        return getattr(importlib.import_module(mod), name)
    obj = importlib.import_module("unet_convlstm_tpu_torch")
    for part in dotted.split("."):
        try:
            obj = getattr(obj, part)
        except AttributeError:
            obj = importlib.import_module(f"{obj.__name__}.{part}")
    return obj


@pytest.mark.parametrize("sub", sorted(SUBPACKAGES))
def test_subpackage_reexports_match_jax(sub):
    names = _jax_reexports(sub)
    assert names, sub
    port = (importlib.import_module(f"unet_convlstm_tpu_torch."
                                    f"{SUBPACKAGES[sub]}")
            if SUBPACKAGES[sub] else None)
    missing = []
    for name in names:
        key = f"{sub}.{name}"
        if key in COUNTERPARTS:
            assert _resolve(COUNTERPARTS[key]) is not None, key
        elif key not in NO_COUNTERPART and not hasattr(port, name):
            missing.append(key)
    assert not missing, missing
    # the lists name nothing the JAX package does not re-export
    listed = [k for k in (*COUNTERPARTS, *NO_COUNTERPART)
              if k.rpartition(".")[0] == sub]
    assert set(listed) <= {f"{sub}.{n}" for n in names}


def test_train_reexports_fit():
    from unet_convlstm_tpu_torch.train import fit
    from unet_convlstm_tpu_torch.train.loop import fit as loop_fit

    assert fit is loop_fit
