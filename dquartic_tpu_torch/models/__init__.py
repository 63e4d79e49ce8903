from .fourier import FourierFeatures
from .transformer import CustomTransformer
from .unet1d import UNet1d

__all__ = ["CustomTransformer", "FourierFeatures", "UNet1d"]
