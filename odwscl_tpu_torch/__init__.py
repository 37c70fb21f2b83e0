"""odwscl_tpu_torch: the PyTorch/CUDA port of ``odwscl_tpu`` for NVIDIA Hopper.

The JAX package ``odwscl_tpu`` is the reference; this package mirrors its
layout and names so that every module has its counterpart at the same
relative path. It imports torch, numpy and the standard library only.

Covered: the training and evaluation paths of every model family of the
JAX ``build_model`` (VOC and COCO, the WSOD variants, int8 serving),
multi-process training, tensor- and spatially-parallel serving over every
body (``parallel/``), the JAX package's Orbax checkpoints, the utilities,
the CLIs and the int8 accuracy study (``tools/int8_accuracy_study.py``).
The ROIPool forward and backward and the int8 conv and quantize run
hand-written CUDA kernels (``csrc/*.cu``) on the card; the
other ops are torch, and the host's proposal cleaning is native C++
(``csrc/host_ops.cpp``).

Entry points default to ``device="cuda"`` and raise when no card is present;
tests pass ``device="cpu"``.
"""

__version__ = "0.1.0"
