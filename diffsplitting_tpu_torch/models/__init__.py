from .forward_utils import apply_unet, fused_enabled
from .fused_forward import fused_unet_forward
from .blocks import Dropout, set_dropout_generator
from .time_predictor import ForegroundMask, TimePredictor
from .unet import UNet

__all__ = ["Dropout", "ForegroundMask", "TimePredictor", "UNet", "apply_unet", "fused_enabled",
           "fused_unet_forward", "set_dropout_generator"]
