"""odwscl_tpu_torch: the PyTorch/CUDA port of ``odwscl_tpu`` for NVIDIA Hopper.

The JAX package ``odwscl_tpu`` is the reference; this package mirrors its
layout and names so that every module has its counterpart at the same
relative path. It imports torch, numpy and the standard library only.

Covered so far: the VOC evaluation path (precomputed proposals -> VGG16-OICR
-> 7x7 ROIPool -> fc6/fc7 -> MIST heads -> AVG/UNION decode -> TTA merge ->
per-class NMS -> VOC mAP / CorLoc). The ROIPool forward runs a hand-written
CUDA kernel (``csrc/roi_pool_fwd.cu``) on the card; every other op is torch.

Entry points default to ``device="cuda"`` and raise when no card is present;
tests pass ``device="cpu"``.
"""

__version__ = "0.1.0"
