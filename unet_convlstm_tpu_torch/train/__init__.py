"""Training (counterpart of unet_convlstm_tpu/train/): the config, the step
and its optimizer, metric sums, checkpoint I/O (torch ``.pt``), the run
(``fit``), the overfit gate and the cloud gate."""

from .checkpoint import (latest_checkpoint, restore_checkpoint,  # noqa: F401
                         save_checkpoint)
from .config import TrainConfig  # noqa: F401
from .loop import fit  # noqa: F401
from .metrics import (MetricSums, metric_sums_init,  # noqa: F401
                      metric_sums_update)
from .optim import (ReduceLROnPlateau, make_optimizer,  # noqa: F401
                    set_learning_rate)
from .steps import make_eval_step, make_train_step  # noqa: F401
