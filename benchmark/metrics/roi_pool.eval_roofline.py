"""``roi_pool.eval_roofline``: the least time of ROIPool #1
(``roi_pool_fwd_kernel``, no argmax) over its summed device time in the
traced eval window, in %. Least time per forward, at its map and its rois
(each image's proposals scaled to the TTA scale and, for a flip, mirrored
in the image's width): the bytes of the map cells the output depends on,
the output, the rois and the mask at the card's memory rate, or its
comparisons at the f32 rate, whichever is longer."""

from benchmark import flops, peaks


def read(ctx):
    c, tr = ctx["counts"], ctx["trace"]
    if c.get("kind") != "eval" or tr is None or not c["batches"]:
        return None
    kernel_s = tr.kernel_seconds(lambda n: "roi_pool_fwd_kernel" in n)
    if kernel_s <= 0:
        return None
    mem = peaks.rate(ctx["card"], peaks.MEM_BYTES_PER_S)
    f32 = peaks.rate(ctx["card"], peaks.F32_OPS_PER_S)
    scale = c["pooler_scale"]
    pooled = c["model"]["pooled"]
    least = 0.0
    for times, forwards in c["forward_rois"]:
        for (h, w), boxes, mask in forwards:
            feat = (boxes.shape[0], int(h * scale), int(w * scale), 512)
            nbytes, ops = flops.roi_pool_work(feat, boxes, mask, scale,
                                              pooled, c["itemsize"])
            least += times * max(nbytes / mem, ops / f32)
    return 100.0 * least / kernel_s
