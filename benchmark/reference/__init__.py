"""The plain reference of the detector the benchmark runs.

Plain PyTorch in float32 with TF32 off (``precision.py`` also offers the
fp8 control), importing nothing of the program: a frozen copy of the
port's plain paths (``odwscl_tpu_torch`` models, losses, mining, ROIPool's
plain versions, transforms, collate, device resize, post-process) for the
one recipe the configurations run: VGG16-OICR, 7x7 ROIPool at 1/8, the
fc6/fc7 neck, MIST heads with box regression, DropBlock, contrastive
mining with SupCon and ``od_layer`` pseudo-labels; 14-transform AVG TTA
with per-class NMS and top-K. It gets the benchmark's own inputs (the
written files, the seed's weights, the generator state the window
started from) and works out everything else itself.
"""
