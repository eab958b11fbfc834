from .unet import UNet

__all__ = ["UNet"]
