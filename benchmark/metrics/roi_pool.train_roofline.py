"""``roi_pool.train_roofline``: the least time of the training ROIPool
kernels, #1[argmax] (``roi_pool_fwd_kernel``) and #2
(``roi_pool_bwd_kernel``), over their summed device time in the traced
window, in %. Least time per step, at its map and rois: #1[argmax]'s bytes
(map cells its output depends on, output, codes) at the card's memory
rate or its comparisons at the f32 rate, whichever is longer, plus #2's
bytes (map, cotangent, gradient) at the memory rate."""

from benchmark import flops, peaks


def read(ctx):
    c, tr = ctx["counts"], ctx["trace"]
    if c.get("kind") != "train" or tr is None or not c["steps"]:
        return None
    kernel_s = tr.kernel_seconds(lambda n: "roi_pool_fwd_kernel" in n
                                 or "roi_pool_bwd_kernel" in n)
    if kernel_s <= 0:
        return None
    mem = peaks.rate(ctx["card"], peaks.MEM_BYTES_PER_S)
    f32 = peaks.rate(ctx["card"], peaks.F32_OPS_PER_S)
    scale = c["pooler_scale"]
    pooled = c["model"]["pooled"]
    least = 0.0
    for shape, boxes, mask in c["shapes"]:
        feat = (shape[0], int(shape[1] * scale), int(shape[2] * scale), 512)
        nbytes, ops = flops.roi_pool_work(feat, boxes, mask, scale, pooled,
                                          c["itemsize"], argmax=True)
        least += max(nbytes / mem, ops / f32)
        least += flops.roi_pool_bwd_bytes(feat, boxes.shape, pooled,
                                          c["itemsize"]) / mem
    return 100.0 * least / kernel_s
