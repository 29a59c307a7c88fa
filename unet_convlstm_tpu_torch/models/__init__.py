"""TemporalUNetDualView, the ResNet18-UNet family, the sequence layout and
the model registry (counterpart of unet_convlstm_tpu/models/). The JAX
package's ``*_init`` functions are the ``nn.Module`` classes here
(``TemporalUNetDualView``, ``PretrainedTemporalUNet``)."""

from .registry import MODEL_REGISTRY, build_model  # noqa: F401
from .resnet_unet import (PretrainedTemporalUNet,  # noqa: F401
                          ResNetUNetConfig, resnet_unet_apply,
                          resnet_unet_init_state)
from .temporal_unet import (TemporalUNetConfig,  # noqa: F401
                            TemporalUNetDualView, temporal_unet_apply,
                            temporal_unet_init_state)
