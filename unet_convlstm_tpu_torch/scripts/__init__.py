"""Run drivers of the port (counterparts of the repo's scripts/*.py): the
long training runs behind the recorded goldens. Each runs as ``python -m
unet_convlstm_tpu_torch.scripts.<name>`` on the card, or with ``--device
cpu`` on the CPU, and has ``main(argv=None) -> int``:

* ``run_resnet_golden``: the ResNet18 family on Moving-MNIST;
* ``pretrain_encoder``: the ResNet18 family trained on a seed-7 cloud
  corpus, its encoder exported as a torchvision ``.pth``;
* ``run_mnist_T40``: Moving-MNIST at the generator's T=40, optionally over
  process generations that resume from ``custom_last.pt``;
* ``run_endurance_200ep``: the reference's 200-epoch schedule, the
  training process killed cold part way and resumed.

Every constant the JAX scripts hard-code is a flag here with the JAX value
as its default, so that a run can be cut; results go under
``results/torch/`` or the work directory, never over the JAX package's
``results/*.json``. Each prints ``launches {...}``: the kernel launches of
its run, those of its child processes included.
"""

import argparse
import os

DEVICE_HELP = "torch device (default: the card; 'cpu' to run without one)"

# the cloud gate's geometry fields that the cloud drivers expose as flags
GEOMETRY = ("nz", "nxy", "n_folders", "n_samples", "render_res", "out_size")


def add_geometry_flags(ap: argparse.ArgumentParser, base, **defaults):
    """``--nz``, ``--nxy``, ``--n-folders``, ``--n-samples``,
    ``--render-res`` and ``--out-size``, defaulting to the fields of the
    gate config ``base`` (``defaults`` overrides some)."""
    for name in GEOMETRY:
        ap.add_argument("--" + name.replace("_", "-"), type=int,
                        default=defaults.get(name, getattr(base, name)))


def geometry(args) -> dict:
    return {name: getattr(args, name) for name in GEOMETRY}


# a child process's kernel launches, added up in its checkpoint directory
LAUNCHES_FILE = "launches.json"
PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def child_env() -> dict:
    """The environment of a driver's child process (``python -m``): this
    package importable from any working directory."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (PKG_PARENT, os.environ.get("PYTHONPATH")) if p))
