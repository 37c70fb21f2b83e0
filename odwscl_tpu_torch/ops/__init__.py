from .deform_conv import (deform_conv2d, deform_psroi_pooling,
                          modulated_deform_conv2d)

__all__ = ["deform_conv2d", "modulated_deform_conv2d",
           "deform_psroi_pooling"]
