"""FBNet bodies: the arch-def interpreter and the inverted-residual blocks.

Counterpart of ``odwscl_tpu/models/fbnet.py``: ``MODEL_ARCH`` (the
"default" arch, MobileNetV2's table), ``_py2_round``, ``_divisible``,
``unify_arch_def``, ``get_blocks``, ``_parse_op``, ``_ConvBN``, ``_SE``,
``_channel_shuffle``, ``IRFBlock``, ``FBNetBlocks`` and ``FBNetTrunk``.
The arch tables and helpers are this package's own copy.

An arch def is ``{"block_op_type": [[op, ...], ...], "block_cfg":
{"first": [c, s], "stages": [[[t, c, n, s], ...], ...], "backbone":
[stage indices]}}``; every [t, c, n, s] unrolls to n blocks, stride s on
the first. Ops: ``skip`` (identity, or a 1x1 conv + norm + ReLU where the
channels or the stride change) and ``ir_k{k}[_e{t}][_s4][_se]`` (an
``IRFBlock``: grouped 1x1 expand, optional channel shuffle, depthwise kxk,
grouped 1x1 project, the residual at stride 1 with equal channels,
optional squeeze-excite). A negative stride is a nearest upsample by
-stride before the depthwise conv, which then runs at stride 1.

Module names follow the flax tree (``first``, ``stages/block{i}`` with
``pw``, ``dw``, ``pwl`` of ``conv`` and ``bn``, ``se`` with ``fc1`` and
``fc2``), so the weight bridge maps names one to one; norms are the
port's ``FrozenBatchNorm``. As the other backbones, the trunk takes NHWC
images, runs on the NCHW view with the f32 parameters cast to the compute
dtype at each use, and returns a contiguous NHWC feature.
"""

from __future__ import annotations

import copy
import json
import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .fpn import conv_nchw
from .resnet import FrozenBatchNorm

MODEL_ARCH: Dict[str, Any] = {
    "default": {
        "block_op_type": [
            ["ir_k3"],
            ["ir_k3"] * 2,
            ["ir_k3"] * 3,
            ["ir_k3"] * 7,
        ],
        "block_cfg": {
            "first": [32, 2],
            "stages": [
                [[1, 16, 1, 1]],
                [[6, 24, 2, 2]],
                [[6, 32, 3, 2]],
                [[6, 64, 4, 2], [6, 96, 3, 1]],
            ],
            "backbone": [0, 1, 2, 3],
        },
    },
}


def _py2_round(x: float) -> int:
    return int(round(x + 1e-9)) if x >= 0 else -int(round(-x + 1e-9))


def _divisible(num: float, divisor: int, min_val: int) -> int:
    if divisor <= 1:
        return _py2_round(num)
    return max(min_val, int(num + divisor / 2) // divisor * divisor)


def unify_arch_def(arch_def: Dict[str, Any]) -> Dict[str, Any]:
    """Expand the [t, c, n, s] stage configs into one dict per block
    ({"stage_idx", "block_idx", "block": [t, c, 1, s], "block_op_type"})."""
    ret = copy.deepcopy(arch_def)
    cfg = ret.pop("block_cfg")
    ops = ret.pop("block_op_type")
    ret.update({k: v for k, v in cfg.items() if k != "stages"})
    blocks: List[Dict[str, Any]] = []
    for stage_idx, (stage, stage_ops) in enumerate(zip(cfg["stages"], ops)):
        expanded = [[t, c, 1, s if i == 0 else 1]
                    for t, c, n, s in stage for i in range(n)]
        if len(expanded) != len(stage_ops):
            raise ValueError(f"stage {stage_idx}: {len(expanded)} blocks vs "
                             f"{len(stage_ops)} op types")
        blocks += [{"stage_idx": stage_idx, "block_idx": block_idx,
                    "block": b, "block_op_type": op}
                   for block_idx, (b, op) in enumerate(zip(expanded,
                                                           stage_ops))]
    ret["stages"] = blocks
    return ret


def get_blocks(arch_def: Dict[str, Any],
               stage_indices: Optional[Sequence[int]] = None,
               block_indices: Optional[Sequence[int]] = None):
    """The unified arch def cut to the given stages and blocks (all when
    None or empty)."""
    ret = copy.deepcopy(arch_def)
    ret["stages"] = [
        b for b in arch_def["stages"]
        if (not stage_indices or b["stage_idx"] in stage_indices)
        and (not block_indices or b["block_idx"] in block_indices)]
    return ret


def _parse_op(op: str) -> Dict[str, Any]:
    """``ir_k5_e3`` -> kernel 5, expansion 3; ``_s4`` -> channel shuffle
    and 1x1 groups of 4; ``_se`` -> squeeze-excite; ``skip`` -> identity;
    ``shuffle`` -> ``ir_k3_s4`` with the stage's expansion."""
    if op == "skip":
        return {"kind": "skip"}
    if op == "shuffle":
        return {"kind": "ir", "kernel": 3, "expansion": None,
                "shuffle": True, "pw_group": 4, "se": False}
    if not op.startswith("ir_k"):
        raise ValueError(f"unknown op {op!r}")
    parts = op.split("_")
    spec = {"kind": "ir", "kernel": int(parts[1][1:]), "expansion": None,
            "shuffle": False, "pw_group": 1, "se": False}
    for p in parts[2:]:
        if p.startswith("e"):
            spec["expansion"] = float(p[1:])
        elif p == "s4":
            spec["shuffle"], spec["pw_group"] = True, 4
        elif p == "se":
            spec["se"] = True
    return spec


@torch.no_grad()
def _trunc_normal(w: torch.Tensor, std: float,
                  generator: torch.Generator) -> None:
    """A normal of ``std`` truncated at two std (flax's truncated normal
    initializers)."""
    x = torch.randn(w.shape, generator=generator)
    while True:
        bad = x.abs() > 2.0
        if not bad.any():
            break
        x[bad] = torch.randn(int(bad.sum()), generator=generator)
    w.copy_(x * std / 0.87962566103423978)


class _ConvBN(nn.Module):
    """``conv`` (kxk, no bias, ``groups``) + ``bn`` (frozen) + ReLU, the
    norm and the ReLU optional; NCHW."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, relu: bool = True, use_bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=kernel // 2, groups=groups, bias=False)
        self.bn = FrozenBatchNorm(cout) if use_bn else None
        self.relu = relu

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``variance_scaling(2, fan_out, truncated_normal)``."""
        c = self.conv
        fan_out = c.out_channels * c.kernel_size[0] ** 2
        _trunc_normal(c.weight, math.sqrt(2.0 / fan_out), generator)
        if self.bn is not None:
            self.bn.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding, 1,
                     c.groups)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class _SE(nn.Module):
    """Squeeze-excite: the spatial mean -> 1x1 ``fc1`` (max(C / 4, 8)) ->
    ReLU -> 1x1 ``fc2`` -> sigmoid, scaling the input's channels."""

    def __init__(self, channels: int):
        super().__init__()
        mid = max(channels // 4, 8)
        self.fc1 = nn.Conv2d(channels, mid, 1)
        self.fc2 = nn.Conv2d(mid, channels, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default ``lecun_normal``, bias 0."""
        for fc in (self.fc1, self.fc2):
            _trunc_normal(fc.weight, math.sqrt(1.0 / fc.in_channels),
                          generator)
            fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(conv_nchw(self.fc2, F.relu(conv_nchw(self.fc1,
                                                                  s))))
        return x * s


def _channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """NCHW channel shuffle: channel i * (C / g) + j moves to j * g + i."""
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


class IRFBlock(nn.Module):
    """The inverted residual: ``pw`` (grouped 1x1 to mid = divisible(C_in *
    expansion)), optional shuffle, ``dw`` (depthwise kxk; its norm and
    ReLU dropped by ``dw_skip_bn``, ``dw_skip_relu``), ``pwl`` (grouped
    1x1, no ReLU), the residual, optional ``se``."""

    def __init__(self, cin: int, out_depth: int, expansion: float,
                 stride: int, kernel: int = 3, width_divisor: int = 1,
                 shuffle: bool = False, pw_group: int = 1, se: bool = False,
                 dw_skip_bn: bool = False, dw_skip_relu: bool = False):
        super().__init__()
        self.residual = stride == 1 and cin == out_depth
        self.stride = stride
        self.shuffle = shuffle
        self.pw_group = pw_group
        mid = _divisible(int(cin * expansion), width_divisor, width_divisor)
        self.pw = _ConvBN(cin, mid, 1, 1, pw_group)
        self.dw = (_ConvBN(mid, mid, kernel, max(stride, 1), mid,
                           relu=not dw_skip_relu, use_bn=not dw_skip_bn)
                   if kernel > 1 else None)
        self.pwl = _ConvBN(mid, out_depth, 1, 1, pw_group, relu=False)
        self.se = _SE(out_depth) if se else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.pw, self.dw, self.pwl, self.se):
            if m is not None:
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw(x)
        if self.shuffle:
            y = _channel_shuffle(y, self.pw_group)
        if self.stride < 0:          # a nearest upsample by -stride
            y = y.repeat_interleave(-self.stride, dim=2).repeat_interleave(
                -self.stride, dim=3)
        if self.dw is not None:
            y = self.dw(y)
        y = self.pwl(y)
        if self.residual:
            y = y + x
        return self.se(y) if self.se is not None else y


class FBNetBlocks(nn.Module):
    """``block{i}`` for each (op, [t, c, n, s]) of ``blocks``: the output
    channels ``divisible(c * scale_factor, width_divisor, 8)``."""

    def __init__(self, cin: int, blocks: Sequence, scale_factor: float = 1.0,
                 width_divisor: int = 1, dw_skip_bn: bool = False,
                 dw_skip_relu: bool = False):
        super().__init__()
        self.n = 0
        for i, (op, (t, c, _n, s)) in enumerate(blocks):
            cout = _divisible(c * scale_factor, width_divisor, 8)
            spec = _parse_op(op)
            if spec["kind"] == "skip":
                block = (_ConvBN(cin, cout, 1, max(s, 1))
                         if cin != cout or s != 1 else None)
            else:
                exp = (spec["expansion"] if spec["expansion"] is not None
                       else t)
                block = IRFBlock(cin, cout, exp, s, spec["kernel"],
                                 width_divisor, spec["shuffle"],
                                 spec["pw_group"], spec["se"], dw_skip_bn,
                                 dw_skip_relu)
            setattr(self, f"block{i}", block)
            self.n += 1
            cin = cout
        self.out_channels = cin

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.n):
            block = getattr(self, f"block{i}")
            if block is not None:
                block.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            block = getattr(self, f"block{i}")
            if block is not None:
                x = block(x)
        return x


def _blocks_of(arch: Dict[str, Any], stage_indices) -> tuple:
    return tuple((b["block_op_type"], tuple(b["block"]))
                 for b in get_blocks(arch, stage_indices)["stages"])


class FBNetTrunk(nn.Module):
    """``first`` (3x3 conv + norm + ReLU at the arch's first stride) and the
    backbone stages (``stages``): NHWC images -> one NHWC feature of
    ``out_channels`` (96 at stride 16 for "default"). ``arch_def`` (JSON,
    ``MODEL.FBNET.ARCH_DEF``) overrides the named arch."""

    def __init__(self, arch: str = "default", arch_def: Optional[str] = None,
                 scale_factor: float = 1.0, width_divisor: int = 1,
                 dw_skip_bn: bool = True, dw_skip_relu: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        raw = json.loads(arch_def) if arch_def else MODEL_ARCH[arch]
        unified = unify_arch_def(raw)
        first_c, first_s = unified["first"]
        cout = _divisible(first_c * scale_factor, width_divisor, 8)
        self.first = _ConvBN(3, cout, 3, first_s)
        n_stages = max(b["stage_idx"] for b in unified["stages"]) + 1
        trunk = unified.get("backbone", list(range(n_stages - 1)))
        self.stages = FBNetBlocks(cout, _blocks_of(unified, trunk),
                                  scale_factor, width_divisor, dw_skip_bn,
                                  dw_skip_relu)
        self.out_channels = self.stages.out_channels

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.first.reset_parameters(generator)
        self.stages.reset_parameters(generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = self.stages(self.first(x))
        return x.permute(0, 2, 3, 1).contiguous()
