from .detector import Batch, WSODDetector, detector_from_cfg
from .retinanet import RetinaNetDetector, retinanet_from_cfg
from .supervised import SupervisedRCNN, supervised_from_cfg

__all__ = ["Batch", "WSODDetector", "detector_from_cfg", "RetinaNetDetector",
           "retinanet_from_cfg", "SupervisedRCNN", "supervised_from_cfg",
           "build_model"]


def build_model(cfg):
    """The model family of a config, as the JAX package's ``build_model``:
    ``MODEL.RETINANET_ON`` -> ``RetinaNetDetector``; else ``MODEL.WSOD_ON``
    -> ``WSODDetector``; else ``SupervisedRCNN`` (Fast / Mask R-CNN by
    ``MASK_ON`` over any ported ``CONV_BODY``)."""
    if cfg.MODEL.RETINANET_ON:
        return retinanet_from_cfg(cfg)
    if cfg.MODEL.WSOD_ON:
        return detector_from_cfg(cfg)
    return supervised_from_cfg(cfg)
