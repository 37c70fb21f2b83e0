"""VGG16-OICR backbone and the fc6/fc7 RoI neck.

Counterpart of ``odwscl_tpu/models/vgg16.py``. The OICR variant drops pool4
and dilates conv5 by 2 (pad 2), so the output stride is 8 with 512
channels, and the final ReLU is stripped.

Training: ``freeze_at`` (``FREEZE_CONV_BODY_AT``) > 0 freezes the first
``FREEZE_CONV_COUNTS[freeze_at - 1]`` convolutions with
``requires_grad_(False)``, so autograd never reaches them (the JAX
package's ``stop_gradient`` at the freeze boundary). The neck's dropout
takes explicit keep masks, one row per RoI, so that a recompute of some
rows can reuse the masks of the all-RoI pass.

Parameters are held in f32, as in the JAX package, and cast to the compute
dtype at each use. Images come in NHWC, the JAX layout; viewed as NCHW they
are ``channels_last`` in memory, so every convolution runs channels_last
and the output features return to NHWC with a free permute. The TPU's
space-to-depth stem (``ops/s2d_stem.py``) is an exact re-association of
conv1_1, conv1_2 and pool1 with the same parameters, so the plain stem
here is its counterpart.

int8 serving (``TPU.INT8_EVAL_CONVS``, ``INT8_STATIC``,
``INT8_BF16_LAYERS``; ``TPU.INT8_EVAL`` for the neck): in ``eval_forward``
only, the convs from index 2 on run in int8 (``ops/quant.py``; the stem
stays in the compute dtype). A calibration forward records each int8
conv's per-input-channel abs-max as a running maximum while it runs the
plain conv; ``int8_static`` then quantizes with those scales instead of
each batch's own abs-max. The recorded scales live in ``act_amax``, a
plain dict outside the ``state_dict``, so every checkpoint still loads
strictly; ``engine/inference.py`` saves and loads them as the JAX
package's ``int8_scales.npz``.

With calibrated scales the next int8 conv's codes depend on this conv's
output alone, so static serving fuses that quantize into the producing
conv's epilogue (``conv_int8_nhwc``'s ``out_scale``; the JAX package
leaves the same fusion to XLA, ``ops/quant.py:65-69`` there): an int8
conv followed by an int8 conv writes the next one's int8 codes, and the
``M`` between them max-pools the codes. Only a conv input after a float
layer (the stem's pool1, a layer of ``int8_bf16_layers``) is quantized on
its own (``quantize_act``). Dynamic serving quantizes every int8 conv's
input with its batch abs-max. ``unfused_int8_forward`` is the unfused
chain the fused one equals bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import (conv_int8_nhwc, conv_weight_codes, dense_int8,
                         per_tensor_scale, quantize_act, quantize_conv_act,
                         quantize_weights)

# Conv counts delimiting the freeze blocks: FREEZE_CONV_BODY_AT = k freezes
# the first FREEZE_CONV_COUNTS[k - 1] convolutions.
FREEZE_CONV_COUNTS = [2, 4, 7, 10, 13]

# Layer spec: int = 3x3 conv channels, 'M' = 2x2 maxpool, 'I' = identity
# (removed pool), '<n>-D' = dilated 3x3 conv.
VGG_CFGS = {
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512],
    "VGG16-OICR": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
                   512, "I", "512-D", "512-D", "512-D"],
    "VGG16-ENCODER": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512,
                      512, 512, "512-D", "512-D", "512-D"],
}


def _version(t: torch.Tensor):
    """What identifies a tensor's values: its storage, device and in-place
    update count (``_version``; an optimizer step or a load bumps it)."""
    return t.data_ptr(), t.device, t._version


def _kept(cache: dict, slot, key, make):
    """``cache[slot]``'s value while its key is ``key``, else ``make()``."""
    hit = cache.get(slot)
    if hit is None or hit[0] != key:
        hit = cache[slot] = (key, make())
    return hit[1]


class VGGBackbone(nn.Module):
    """NHWC images [B, H, W, 3] -> NHWC features [B, H/8, W/8, 512]
    (OICR variant), contiguous."""

    def __init__(self, arch: str = "VGG16-OICR",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 freeze_at: int = 0, int8_eval: bool = False,
                 int8_static: bool = False,
                 int8_bf16_layers: Tuple[int, ...] = ()):
        super().__init__()
        self.arch = arch
        self.compute_dtype = compute_dtype
        self.int8_eval = int8_eval
        self.int8_static = int8_static
        self.int8_bf16_layers = tuple(int8_bf16_layers)
        # conv index -> calibrated per-input-channel abs-max [Cin] (or a 0-d
        # abs-max from an old scales file); not in the state_dict
        self.act_amax: Dict[int, torch.Tensor] = {}
        self._wq: Dict[int, tuple] = {}   # conv index -> (key, weight codes)
        self.spec = VGG_CFGS[arch]
        self._layers = []  # (conv index, dilation) or "M"
        cin, i = 3, 0
        for v in self.spec:
            if v in ("M", "I"):
                if v == "M":
                    self._layers.append("M")
                continue
            dilated = isinstance(v, str) and v.endswith("-D")
            ch = int(v.split("-")[0]) if dilated else int(v)
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3))
            self._layers.append((i, 2 if dilated else 1))
            cin, i = ch, i + 1
        self.num_convs = i
        self.out_channels = cin
        for k in range(FREEZE_CONV_COUNTS[freeze_at - 1] if freeze_at > 0
                       else 0):
            getattr(self, f"conv{k}").requires_grad_(False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-normal fan-out convs with zero bias, as the JAX init."""
        for i in range(self.num_convs):
            conv = getattr(self, f"conv{i}")
            fan_out = conv.out_channels * 9
            conv.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                                generator=generator)
            conv.bias.zero_()

    def _weight_codes(self, i: int, weight: torch.Tensor,
                      scale: Optional[torch.Tensor]):
        """conv ``i``'s ``conv_weight_codes``, kept until its weight or its
        scales change. With a calibrated scale it also holds the dequantize
        scale of the int32 sums [Cout] and the input's quantize scale [Cin]
        (per channel, or the per-tensor scale broadcast)."""
        key = (_version(weight), None if scale is None else _version(scale))

        def make():
            kq, ks, sa = conv_weight_codes(weight.detach(), scale)
            if scale is None:
                return kq, ks, sa
            if sa is not None:
                return kq, ks, sa, ks, sa
            xs = per_tensor_scale(scale.to(weight.device))
            return (kq, ks, sa, xs * ks,
                    xs.expand(weight.shape[1]).contiguous())

        return _kept(self._wq, i, key, make)

    def int8_convs(self) -> Tuple[int, ...]:
        """The conv indices that run in int8 on the serving path."""
        if not self.int8_eval:
            return ()
        return tuple(i for i in range(2, self.num_convs)
                     if i not in self.int8_bf16_layers)

    def _static_scale(self, i: int) -> torch.Tensor:
        if i not in self.act_amax:
            raise RuntimeError(
                f"int8 static serving: conv{i} has no calibrated scale (run "
                "a calibration forward or load int8_scales.npz first)")
        return self.act_amax[i]

    def forward(self, images: torch.Tensor, fast_eval: bool = False,
                calibrate: bool = False) -> torch.Tensor:
        """``fast_eval`` (eval only) takes the int8 convs when
        ``int8_eval``; with ``calibrate`` they run the plain conv and
        record their inputs' per-channel abs-maxes into ``act_amax``."""
        dt = self.compute_dtype
        int8 = self.int8_convs() if fast_eval else ()
        static = self.int8_static and not calibrate
        if static:
            for i in int8:
                self._static_scale(i)
        x = images.to(dt).permute(0, 3, 1, 2)  # NCHW view, channels_last
        codes = None   # NHWC int8 codes of the next conv's input, if fused
        layers = self._layers
        for li, layer in enumerate(layers):
            if layer == "M":
                if codes is None:
                    x = F.max_pool2d(x, 2, 2)
                continue           # codes come pooled from their conv
            i, dil = layer
            conv = getattr(self, f"conv{i}")
            # the reference strips the final ReLU
            relu = i + 1 < self.num_convs
            if i in int8 and calibrate:
                amax = x.abs().amax(dim=(0, 2, 3)).to(torch.float32)
                prev = self.act_amax.get(i)
                self.act_amax[i] = (amax if prev is None else
                                    torch.maximum(prev.to(amax.device), amax))
            elif i in int8 and static:
                kq, _, _, deq, s_in = self._weight_codes(
                    i, conv.weight, self._static_scale(i))
                if codes is None:
                    codes = quantize_act(x.permute(0, 2, 3, 1), s_in)[0]
                if i + 1 in int8:  # the next conv's codes, pooled if "M"
                    s_out = self._weight_codes(
                        i + 1, getattr(self, f"conv{i + 1}").weight,
                        self._static_scale(i + 1))[4]
                    pool = li + 1 < len(layers) and layers[li + 1] == "M"
                    codes = conv_int8_nhwc(codes, kq, deq, conv.bias, dil,
                                           dil, dt, relu, out_scale=s_out,
                                           pool=pool)
                else:
                    x = conv_int8_nhwc(codes, kq, deq, conv.bias, dil, dil,
                                       dt, relu).permute(0, 3, 1, 2)
                    codes = None
                continue
            elif i in int8:
                kq, ks, _ = self._weight_codes(i, conv.weight, None)
                xq, xs = quantize_act(x.permute(0, 2, 3, 1))
                x = conv_int8_nhwc(xq, kq, xs * ks, conv.bias, dil, dil, dt,
                                   relu).permute(0, 3, 1, 2)
                continue
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                         padding=dil, dilation=dil)
            if relu:
                x = F.relu(x)
        return x.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def unfused_int8_forward(backbone: VGGBackbone, images: torch.Tensor
                         ) -> torch.Tensor:
    """The static int8 serving forward as an unfused chain of
    ``ops/quant.py`` calls: each int8 conv's input quantized on its own
    (``quantize_conv_act``, plain torch ops), the convs writing the compute
    dtype, the pools on those values. The fused ``backbone(images,
    fast_eval=True)`` equals it bit for bit (the CPU tests; on the card,
    ``chip_smoke.py``)."""
    dt = backbone.compute_dtype
    int8 = backbone.int8_convs()
    x = images.to(dt).permute(0, 3, 1, 2)
    for layer in backbone._layers:
        if layer == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        i, dil = layer
        conv = getattr(backbone, f"conv{i}")
        relu = i + 1 < backbone.num_convs
        if i in int8:
            scale = backbone._static_scale(i)
            kq, ks, sa = conv_weight_codes(conv.weight, scale)
            xq, xs = quantize_conv_act(x.permute(0, 2, 3, 1).contiguous(),
                                       sa, scale)
            x = conv_int8_nhwc(xq, kq, ks if xs is None else xs * ks,
                               conv.bias, dil, dil, dt,
                               relu).permute(0, 3, 1, 2)
            continue
        x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=dil,
                     dilation=dil)
        if relu:
            x = F.relu(x)
    return x.permute(0, 2, 3, 1).contiguous()


class VGGRoINeck(nn.Module):
    """fc6/fc7 over pooled rois flattened in (h, w, c) order: [N, r, r, C]
    (r the pooler's resolution; ``in_dim`` = r*r*C) -> [N, hidden]. Dropout
    applies only where keep masks are given. ``mid_dim`` (default
    ``hidden_dim``) is fc6's width."""

    def __init__(self, in_dim: int = 512 * 7 * 7, hidden_dim: int = 4096,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.5, mid_dim: Optional[int] = None,
                 int8_eval: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.int8_eval = int8_eval
        self._wq: Dict[int, tuple] = {}   # fc6, fc7 -> (key, weight codes)
        self.dropout_rate = dropout_rate
        mid_dim = mid_dim or hidden_dim
        self.fc6 = nn.Linear(in_dim, mid_dim)
        self.fc7 = nn.Linear(mid_dim, hidden_dim)

    def draw_keep(self, n: int, generator: torch.Generator, device
                  ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Train-mode keep masks of fc6 and fc7 for n rows ([n, width of
        the layer] bool each), or None when the dropout rate is 0."""
        if self.dropout_rate == 0.0:
            return None
        return tuple(torch.rand((n, fc.out_features), generator=generator,
                                device=device) >= self.dropout_rate
                     for fc in (self.fc6, self.fc7))

    def _weight_codes(self, li: int, weight: torch.Tensor):
        """The layer's ``quantize_weights``, kept until its weight changes."""
        return _kept(self._wq, li, _version(weight),
                     lambda: quantize_weights(weight.detach()))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for fc in (self.fc6, self.fc7):
            fc.weight.normal_(0.0, 0.01, generator=generator)
            fc.bias.zero_()

    def forward(self, x: torch.Tensor,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                fast_eval: bool = False) -> torch.Tensor:
        """``keep``: the fc6 and fc7 keep masks of these rows (train-mode
        dropout, kept units scaled by 1 / (1 - rate)), or None.
        ``fast_eval`` (eval only) runs both layers in int8 (``dense_int8``)
        when ``int8_eval``."""
        dt = self.compute_dtype
        int8 = fast_eval and self.int8_eval
        x = x.reshape(x.shape[0], -1).to(dt)
        for li, fc in enumerate((self.fc6, self.fc7)):
            x = F.relu(dense_int8(x, fc.weight, fc.bias, dt,
                                  self._weight_codes(li, fc.weight))
                       if int8 else
                       F.linear(x, fc.weight.to(dt), fc.bias.to(dt)))
            if keep is not None:
                x = torch.where(keep[li], x / (1.0 - self.dropout_rate),
                                0.0).to(dt)
        return x
