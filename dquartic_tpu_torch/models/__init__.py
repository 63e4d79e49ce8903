from .unet1d import UNet1d

__all__ = ["UNet1d"]
