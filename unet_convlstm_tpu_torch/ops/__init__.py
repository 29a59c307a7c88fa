"""Primitives, blocks, ConvLSTM, normalization, losses and the CUDA kernels
(counterpart of unet_convlstm_tpu/ops/). The JAX package's ``*_init``
functions are the ``nn.Module`` classes here (``Conv2d``, ``DoubleConv``,
``ConvLSTM``, ...). The function ``convlstm`` stays in its module
(``ops.convlstm.convlstm``): re-exported here it would hide the module of
the same name."""

from .blocks import (DoubleConv, Down, OutConv, SpatialAttention,  # noqa: F401
                     Up, double_conv, down, out_conv, spatial_attention, up)
from .conv import (Conv2d, ConvTranspose2d, batchnorm, conv2d,  # noqa: F401
                   conv_transpose2d, max_pool2d)
from .convlstm import (ConvLSTM, ConvLSTMCell,  # noqa: F401
                       convlstm_cell_step, convlstm_zero_state)
from .losses import compute_loss, masked_mse  # noqa: F401
from .normalize import (NormStats, compute_mask,  # noqa: F401
                        compute_norm_stats, denormalize_y, normalize_x,
                        normalize_y)
from .resize import area_resize  # noqa: F401
