"""Time the int8 conv kernel's block tiles at the VGG16 int8 layer shapes.

    python -m odwscl_tpu_torch.tools.tune_conv_int8 [--scale 1200]
        [--iters 5] [--rounds 3]

Each tile of ``csrc/conv_int8.cu`` (``ops/quant.py:CONV_TILES``) is first
checked bit for bit against ``conv2d_int8_acc_plain`` at a few shapes, then
timed with cuDNN's bf16 conv of the same shape beside it, in turns, at the
11 int8 convs (conv2-conv12) of one padded batch of 8 VOC images (375x500)
at ``--scale``. ``ops/quant.py:conv_tile`` was chosen from these readings.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics

import torch
import torch.nn.functional as F

# the VGG16-OICR int8 convs: (index, stride, Cin, Cout, dilation); conv12,
# the last, has no ReLU
INT8_LAYERS = [(2, 2, 64, 128, 1), (3, 2, 128, 128, 1), (4, 4, 128, 256, 1),
               (5, 4, 256, 256, 1), (6, 4, 256, 256, 1), (7, 8, 256, 512, 1),
               (8, 8, 512, 512, 1), (9, 8, 512, 512, 1), (10, 8, 512, 512, 2),
               (11, 8, 512, 512, 2), (12, 8, 512, 512, 2)]
# padded canvases of a batch of 375x500 images at a TTA scale (the short
# side to the scale, padded to multiples of 128)
CANVAS = {480: (512, 640), 1200: (1280, 1664)}


def conv_inputs(dev, gen, b, h, w, cin, cout):
    """Post-ReLU bf16 activations NHWC (channel magnitudes over 10x) and
    Kaiming-scale OIHW f32 weights with a bias, on ``dev``."""
    mags = torch.logspace(0, 1, cin, device=dev)
    x = (torch.randn((b, h, w, cin), generator=gen, device=dev).relu_()
         * mags).to(torch.bfloat16)
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (
        2.0 / (9 * cout)) ** 0.5
    bias = torch.randn((cout,), generator=gen, device=dev) * 0.1
    return x, wt, bias


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tiles_for(cin: int):
    from odwscl_tpu_torch.ops.quant import CONV_TILES

    return [t for t in CONV_TILES if not t.endswith("k128") or cin % 128 == 0]


def main(argv=None) -> dict:
    from odwscl_tpu_torch.ops import quant as q
    from odwscl_tpu_torch.utils.profiling import card_name_and_limit

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=1200,
                        choices=sorted(CANVAS))
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tune_conv_int8 times the kernel on a CUDA card; "
                           "none is available")
    dev = torch.device("cuda", 0)
    print(card_name_and_limit())
    q.CONV_KERNEL.get()
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, h, w, cin, cout, d in [(1, 37, 53, 64, 128, 1),
                                  (2, 37, 53, 512, 512, 2),
                                  (1, 37, 53, 128, 256, 2)]:
        x, wt, _ = conv_inputs(dev, gen, b, h, w, cin, cout)
        xq, kq, _ = q.quantize_conv_input(x, wt)
        ref = q.conv2d_int8_acc_plain(xq, kq, d, d)
        for tile in tiles_for(cin):
            if not torch.equal(q.conv_int8_acc(xq, kq, d, d, tile), ref):
                raise AssertionError(f"tile {tile} differs from the plain "
                                     f"accumulator at {(b, h, w, cin, cout)}")
    print("[tune] every tile bit-exact against conv2d_int8_acc_plain")
    hc, wc = CANVAS[args.scale]
    sums = {}
    for i, s, cin, cout, d in INT8_LAYERS:
        h, w = hc // s, wc // s
        x, wt, bias = conv_inputs(dev, gen, 8, h, w, cin, cout)
        xq, kq, scale = q.quantize_conv_input(x, wt)
        xc, wb, bb = (x.permute(0, 3, 1, 2), wt.to(torch.bfloat16),
                      bias.to(torch.bfloat16))
        fns = {t: (lambda t=t: q.conv_int8_nhwc(
            xq, kq, scale, bias, d, d, torch.bfloat16, i < 12, t))
            for t in tiles_for(cin)}
        fns["cudnn_bf16"] = lambda: F.conv2d(xc, wb, bb, padding=d,
                                             dilation=d)
        reads = {k: [] for k in fns}
        for _ in range(args.rounds):
            for k, fn in fns.items():
                reads[k].append(cuda_ms(fn, args.iters))
        ops = 2.0 * 8 * h * w * cout * 9 * cin
        line = []
        means = {k: statistics.mean(v) for k, v in reads.items()}
        means["shipped"] = means[q.conv_tile(cin)]
        for k, ms in means.items():
            sums[k] = sums.get(k, 0.0) + ms
            if k != "shipped":
                line.append(f"{k} {ms:.4f} ms ({ops / ms / 1e9:.0f} TOP/s)")
        print(f"[tune] conv{i} [8,{h},{w},{cin}]->{cout} dil {d}: "
              + ", ".join(line) + f"; shipped {q.conv_tile(cin)}")
        del x, xq, xc
    print("[tune] sums over the layers each runs (shipped: all 11): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sums.items()))
    return sums


if __name__ == "__main__":
    main()
