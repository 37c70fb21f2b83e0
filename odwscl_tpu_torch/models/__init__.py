from .detector import Batch, WSODDetector, detector_from_cfg

__all__ = ["Batch", "WSODDetector", "detector_from_cfg"]
