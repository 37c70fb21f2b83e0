from .detector import Batch, WSODDetector, detector_from_cfg
from .fbnet import FBNetTrunk
from .keypoint_head import KeypointHead
from .retinanet import RetinaNetDetector, retinanet_from_cfg
from .supervised import SupervisedRCNN, supervised_from_cfg

__all__ = ["Batch", "WSODDetector", "detector_from_cfg", "FBNetTrunk",
           "KeypointHead", "RetinaNetDetector", "retinanet_from_cfg",
           "SupervisedRCNN", "supervised_from_cfg", "build_model"]


def build_model(cfg):
    """The model family of a config, as the JAX package's ``build_model``:
    ``MODEL.RETINANET_ON`` -> ``RetinaNetDetector``; else ``MODEL.WSOD_ON``
    -> ``WSODDetector``; else ``SupervisedRCNN`` (Fast / Mask / Keypoint
    R-CNN by ``MASK_ON`` and ``KEYPOINT_ON`` over any ``CONV_BODY``,
    FBNet included)."""
    if cfg.MODEL.RETINANET_ON:
        return retinanet_from_cfg(cfg)
    if cfg.MODEL.WSOD_ON:
        return detector_from_cfg(cfg)
    return supervised_from_cfg(cfg)
