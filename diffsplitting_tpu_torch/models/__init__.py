from .forward_utils import apply_unet, fused_enabled
from .fused_forward import fused_unet_forward
from .unet import UNet

__all__ = ["UNet", "apply_unet", "fused_enabled", "fused_unet_forward"]
