"""Spatially-parallel backbone serving: every body of the port sharded by
image height, with halo exchanges.

Counterpart of ``odwscl_tpu/parallel/sp.py`` (a serving option; no CLI
uses it in either package), where GSPMD partitions the convolutions over
an ``sp`` mesh axis and inserts the halo exchanges itself. Here each of
``world`` ranks convolves one horizontal band of the images. It covers every
body the port builds: the VGG16 bodies, ``ResNetBackbone`` (R-18/50/101,
C4 and C5, C5 at stride 16 or 32), ``ResNetFPNBackbone``,
``ResNetFPNP3P7Backbone`` and ``FBNetTrunk``. The band arithmetic is kept
apart from the transport:

- ``sp_bands``: a band holds whole rows at the deepest stride S the body
  reaches (8 for VGG16-OICR, 16 for VGG16, the stride-16 ResNets and
  FBNet "default", 32 for the FPN bodies' C5), the output's rows at S
  shared out as evenly as possible, the last band running to the image's
  bottom. Every level of the body is then banded at integer rows: each
  band's output rows of a stride-2 op start at its input rows / 2, so
  every pool and strided conv samples the grid it samples on the whole
  image (VGG16's 2x2 pools floor, the padded convs and pools of the
  others give ceil(h / 2) rows), and a height that is not a multiple of
  S x world gives the unsharded result;
- ``window_plan``: for a conv or pool of kernel k, stride t, padding p,
  dilation d, the input rows each rank needs and the output bands. Rows
  above 0 or past the level's height are padding (zero for a conv, -inf
  for a max pool, the unsharded op's own padding there); the others come
  from the rank itself or a neighbour, and a band thinner than the halo
  its neighbour needs raises and names both. 1x1 convs need no halo
  (a strided one only drops rows); the FPN's nearest 2x upsample and
  FBNet's negative stride (a nearest upsample) map each band's rows onto
  the finer band of the same rank; FrozenBatchNorm, ReLU and the residual
  adds are elementwise; FBNet's squeeze-excite mean reduces over the whole
  map, so the bands' f32 sums are all-reduced (world 1: the module's own
  mean);
- a ``Transport`` moves rows: ``DistTransport`` (``torch.distributed``
  point-to-point exchanges, an all-reduce, an all-gather) in
  ``sp_backbone_apply``, ``ThreadTransport`` (W threads of one process
  sharing their bands) in ``sp_stitch``, which runs W bands on one card.

The FPN's top block (P6 as a 1x1 stride-2 max pool of P5; P6 and P7 as
stride-2 3x3 convs on C5 or P5) runs on the gathered P5 or C5 on every
rank: at H = 128, P6 has 2 rows and P7 one, fewer than the ranks. A body
returns what the module returns, one NHWC map or a tuple of NHWC
levels:
``gather=True`` all-gathers every banded level, so every rank holds the
whole maps (the RoI stage needs whole rois); ``gather=False`` leaves each
rank its band of each banded level (the top block's levels are whole).

At world size 1 the band is the image and every op runs exactly as the
module's forward runs it (the same calls, shapes and arguments), so the
result is the module's bit for bit. Float paths only (the int8 serving
convs are not sharded).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.fbnet import FBNetTrunk, IRFBlock, _channel_shuffle, _ConvBN
from ..models.fpn import FPN, ResNetFPNBackbone, conv_nchw
from ..models.resnet import BasicBlock, Bottleneck, ResNetBackbone
from ..models.vgg16 import VGGBackbone


# -- the band arithmetic ---------------------------------------------------

@dataclass(frozen=True)
class Bands:
    """The row bands of one map level: ``height`` rows, rank r holding
    rows [bounds[r][0], bounds[r][1])."""
    height: int
    bounds: Tuple[Tuple[int, int], ...]

    def rows(self, rank: int) -> int:
        lo, hi = self.bounds[rank]
        return hi - lo

    def scaled(self, m: int) -> "Bands":
        """The bands after a nearest upsample by ``m``."""
        return Bands(self.height * m,
                     tuple((lo * m, hi * m) for lo, hi in self.bounds))


def sp_bands(height: int, stride: int, world: int,
             rows: Optional[int] = None) -> List[Tuple[int, int]]:
    """Each rank's input rows [start, stop) for a body whose deepest
    stride is ``stride`` and whose output has ``rows`` rows there (default
    H // stride, VGG16's floor pools; the padded bodies have ceil(H /
    stride)): whole rows at that stride, ceil(rows / world) a rank, the
    last band running to the image's bottom. Raises when a band would be
    empty."""
    rows = height // stride if rows is None else rows
    per = math.ceil(rows / world)
    if (world - 1) * per >= rows:
        raise ValueError(f"a height of {height} rows ({rows} rows at stride "
                         f"{stride}) leaves a band of {world} empty")
    return [(r * per * stride,
             height if r + 1 == world else (r + 1) * per * stride)
            for r in range(world)]


@dataclass(frozen=True)
class Window:
    """A conv or pool on banded rows: ``need[r]`` = the input rows [a, b)
    rank r reads (rows outside [0, height) are padding), ``out`` the
    output bands."""
    bands: Bands
    need: Tuple[Tuple[int, int], ...]
    out: Bands

    def recv(self, rank: int) -> Tuple[int, int]:
        """The rows rank takes from the rank above and from the one
        below."""
        (lo, hi), (a, b) = self.bands.bounds[rank], self.need[rank]
        return max(0, lo - max(a, 0)), max(0, min(b, self.bands.height) - hi)

    def send(self, rank: int) -> Tuple[int, int]:
        """The rows rank gives the rank above (its first) and the one
        below (its last)."""
        world = len(self.bands.bounds)
        return (self.recv(rank - 1)[1] if rank > 0 else 0,
                self.recv(rank + 1)[0] if rank + 1 < world else 0)


def window_plan(bands: Bands, k: int, t: int = 1, p: int = 0, d: int = 1,
                what: str = "conv") -> Window:
    """The rows each rank needs for a ``k``-tap window of stride ``t``,
    padding ``p`` and dilation ``d``, and the output bands: rank r's
    output rows start at its first input row / t (the bands start at
    multiples of t), the last rank's end at the level's output height.
    Raises when a band does not start on the stride, when an output band
    would be empty, and when a rank needs rows past its neighbours'."""
    height, world = bands.height, len(bands.bounds)
    out_h = (height + 2 * p - d * (k - 1) - 1) // t + 1
    if any(lo % t for lo, _ in bands.bounds):
        raise ValueError(f"bands {bands.bounds} do not start on the "
                         f"stride {t} of a {k}x{k} {what}")
    out = tuple((lo // t, hi // t if r + 1 < world else out_h)
                for r, (lo, hi) in enumerate(bands.bounds))
    if any(lo >= hi for lo, hi in out):
        raise ValueError(f"a {k}x{k} stride-{t} {what} leaves an empty "
                         f"band of {out} rows")
    need = tuple((lo * t - p, (hi - 1) * t - p + d * (k - 1) + 1)
                 for lo, hi in out)
    plan = Window(bands, need, Bands(out_h, out))
    for r in range(world):
        up, down = plan.recv(r)
        for n, nb in ((up, r - 1), (down, r + 1)):
            if n and bands.rows(nb) < n:
                raise ValueError(
                    f"a band of {bands.rows(nb)} rows (rank {nb}) is thinner "
                    f"than the {n}-row halo rank {r} needs for a {k}x{k} "
                    f"{what} (dilation {d}, stride {t})")
    return plan


# -- the transports ---------------------------------------------------------

class DistTransport:
    """Rows between the ranks of a ``torch.distributed`` group."""

    def __init__(self, group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _peer(self, rank: int) -> int:
        return rank if self.group is None else \
            dist.get_global_rank(self.group, rank)

    def halo(self, x: torch.Tensor, send: Tuple[int, int],
             recv: Tuple[int, int]):
        """(rows from above, rows from below) of the band x [B, C, h, W]:
        its first ``send[0]`` rows go up, its last ``send[1]`` down."""
        b, c, h, w = x.shape
        above = x.new_empty(b, c, recv[0], w)
        below = x.new_empty(b, c, recv[1], w)
        ops = []
        if send[0]:
            ops.append(dist.P2POp(dist.isend, x[:, :, :send[0]].contiguous(),
                                  self._peer(self.rank - 1), self.group))
        if recv[0]:
            ops.append(dist.P2POp(dist.irecv, above,
                                  self._peer(self.rank - 1), self.group))
        if send[1]:
            ops.append(dist.P2POp(dist.isend,
                                  x[:, :, h - send[1]:].contiguous(),
                                  self._peer(self.rank + 1), self.group))
        if recv[1]:
            ops.append(dist.P2POp(dist.irecv, below,
                                  self._peer(self.rank + 1), self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return above, below

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather_rows(self, band: torch.Tensor, bands: Bands,
                        dim: int) -> torch.Tensor:
        """The whole map from each rank's band along ``dim``."""
        most = max(bands.rows(r) for r in range(self.world))
        pad = list(band.shape)
        pad[dim] = most - band.shape[dim]
        padded = torch.cat([band, band.new_zeros(pad)], dim).contiguous()
        parts = [torch.empty_like(padded) for _ in range(self.world)]
        dist.all_gather(parts, padded, group=self.group)
        return torch.cat([p.narrow(dim, 0, bands.rows(r))
                          for r, p in enumerate(parts)], dim)


class _Stitch:
    """What the threads of ``sp_stitch`` share."""

    def __init__(self, world: int):
        self.slots = [None] * world
        self.barrier = threading.Barrier(world)


class ThreadTransport:
    """Rows between the W threads of one process, each holding one band
    (``sp_stitch``)."""

    def __init__(self, stitch: _Stitch, rank: int):
        self.stitch, self.rank = stitch, rank
        self.world = len(stitch.slots)

    def _share(self, value):
        s = self.stitch
        s.slots[self.rank] = value
        s.barrier.wait()
        out = list(s.slots)
        s.barrier.wait()
        return out

    def halo(self, x: torch.Tensor, send: Tuple[int, int],
             recv: Tuple[int, int]):
        bands = self._share(x)
        above = bands[self.rank - 1][:, :, -recv[0]:] if recv[0] else \
            x[:, :, :0]
        below = bands[self.rank + 1][:, :, :recv[1]] if recv[1] else \
            x[:, :, :0]
        return above, below

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        parts = self._share(t)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    def all_gather_rows(self, band: torch.Tensor, bands: Bands,
                        dim: int) -> torch.Tensor:
        return torch.cat(self._share(band), dim)


# -- the banded ops --------------------------------------------------------

class _Banded:
    """One rank's side of a banded forward."""

    def __init__(self, transport):
        self.t = transport
        self.rank, self.world = transport.rank, transport.world

    def _extend(self, x: torch.Tensor, plan: Window, fill: float
                ) -> torch.Tensor:
        """x's rows of the plan's need: padding, the neighbours' rows and
        its own."""
        r = self.rank
        above, below = self.t.halo(x, plan.send(r), plan.recv(r))
        (lo, hi), (a, b) = plan.bands.bounds[r], plan.need[r]
        n, c, _, w = x.shape
        parts = [x.new_full((n, c, max(0, -a), w), fill), above,
                 x[:, :, max(a, lo) - lo:min(b, hi) - lo], below,
                 x.new_full((n, c, max(0, b - plan.bands.height), w), fill)]
        return torch.cat([p for p in parts if p.shape[2]], 2)

    def conv(self, conv, x: torch.Tensor, bands: Bands):
        """``conv`` (an ``nn.Conv2d``: its stride, padding, dilation and
        groups; bias when it has one) on the band, in x's dtype."""
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        return self.conv2d(x, conv.weight.to(x.dtype), bias, bands,
                           conv.stride[0], conv.padding[0], conv.dilation[0],
                           conv.groups)

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, bias, bands: Bands,
               t: int = 1, p: int = 0, d: int = 1, groups: int = 1):
        """``F.conv2d(x, w, bias, t, p, d, groups)`` on the band."""
        plan = window_plan(bands, w.shape[2], t, p, d)
        if self.world == 1:
            return F.conv2d(x, w, bias, t, p, d, groups), plan.out
        return F.conv2d(self._extend(x, plan, 0.0), w, bias, t, (0, p), d,
                        groups), plan.out

    def max_pool(self, x: torch.Tensor, bands: Bands, k: int, t: int,
                 p: int = 0):
        plan = window_plan(bands, k, t, p, what="max pool")
        if self.world == 1:
            return F.max_pool2d(x, k, t, p), plan.out
        return F.max_pool2d(self._extend(x, plan, -math.inf), k, t,
                            (0, p)), plan.out

    def gather(self, band: torch.Tensor, bands: Bands, dim: int
               ) -> torch.Tensor:
        if self.world == 1:
            return band
        return self.t.all_gather_rows(band, bands, dim)

    def spatial_mean(self, x: torch.Tensor, bands: Bands) -> torch.Tensor:
        """The mean over the whole map's rows and columns, keepdim."""
        if self.world == 1:
            return x.mean(dim=(2, 3), keepdim=True)
        total = self.t.all_reduce_sum(
            x.float().sum(dim=(2, 3), keepdim=True))
        return (total / (bands.height * x.shape[3])).to(x.dtype)

    # -- VGG16 -----------------------------------------------------------
    def vgg(self, bb: VGGBackbone, images: torch.Tensor, bands: Bands):
        """``VGGBackbone.forward`` (float) on the band."""
        dt = bb.compute_dtype
        x = images.to(dt).permute(0, 3, 1, 2)
        for layer in bb._layers:
            if layer == "M":
                x, bands = self.max_pool(x, bands, 2, 2)
                continue
            i, d = layer
            conv = getattr(bb, f"conv{i}")
            x, bands = self.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                                   bands, 1, d, d)
            if i + 1 < bb.num_convs:
                x = F.relu(x)
        return [(x.permute(0, 2, 3, 1).contiguous(), bands)]

    # -- ResNet ----------------------------------------------------------
    def resnet(self, bb: ResNetBackbone, images: torch.Tensor,
               bands: Bands):
        """``ResNetBackbone.forward`` on the band: the NCHW output (or,
        ``return_stages``, each stage's NHWC) with its bands."""
        x = images.to(bb.compute_dtype).permute(0, 3, 1, 2)
        x, bands = self.conv(bb.stem_conv, x, bands)
        x = F.relu(bb.stem_bn(x))
        x, bands = self.max_pool(x, bands, 3, 2, 1)
        stages = []
        for name in bb.blocks:
            x, bands = self.block(getattr(bb, name), x, bands)
            if bb.return_stages and name in bb.stage_ends:
                stages.append((x.permute(0, 2, 3, 1).contiguous(), bands))
        if bb.return_stages:
            return stages
        return [(x.permute(0, 2, 3, 1).contiguous(), bands)]

    def block(self, blk, x: torch.Tensor, bands: Bands):
        if isinstance(blk, Bottleneck):
            out, b = self.conv(blk.conv1, x, bands)
            out = F.relu(blk.bn1(out))
            out, b = self.conv(blk.conv2, out, b)
            out = F.relu(blk.bn2(out))
            out, b = self.conv(blk.conv3, out, b)
            out = blk.bn3(out)
        elif isinstance(blk, BasicBlock):
            out, b = self.conv(blk.conv1, x, bands)
            out = F.relu(blk.bn1(out))
            out, b = self.conv(blk.conv2, out, b)
            out = blk.bn2(out)
        else:
            raise NotImplementedError(type(blk).__name__)
        if blk.downsample is None:
            identity = x
        else:
            identity, _ = self.conv(blk.downsample, x, bands)
            identity = blk.downsample_bn(identity)
        return F.relu(out + identity), b

    # -- FPN ---------------------------------------------------------------
    def fpn(self, fpn: FPN, stages):
        """``FPN.forward`` on the banded stages [(NHWC band, bands)]:
        [(NCHW level, its bands or None when whole)]."""
        feats = [f.to(fpn.compute_dtype).permute(0, 3, 1, 2)
                 for f, _ in stages]
        fb = [b for _, b in stages]
        n = len(feats)
        last_inner, lb = self.conv(getattr(fpn, f"fpn_inner{n}"), feats[-1],
                                   fb[-1])
        results = [self.conv(getattr(fpn, f"fpn_layer{n}"), last_inner, lb)]
        for idx in range(n - 2, -1, -1):
            if fpn.in_channels_list[idx] == 0:
                continue
            lateral, b = self.conv(getattr(fpn, f"fpn_inner{idx + 1}"),
                                   feats[idx], fb[idx])
            if lb.scaled(2).bounds[self.rank][0] != b.bounds[self.rank][0]:
                raise ValueError(f"the 2x upsample of bands {lb.bounds} "
                                 f"misses the lateral's {b.bounds}")
            top_down = F.interpolate(last_inner, scale_factor=2,
                                     mode="nearest")
            top_down = top_down[..., :lateral.shape[2], :lateral.shape[3]]
            last_inner, lb = lateral + top_down, b
            results.insert(0, self.conv(
                getattr(fpn, f"fpn_layer{idx + 1}"), last_inner, lb))
        whole = []
        if fpn.top_block == "maxpool":
            p5, b5 = results[-1]
            whole.append(F.max_pool2d(self.gather(p5, b5, 2), 1, 2))
        elif fpn.top_block == "p6p7":
            src, sb = ((feats[-1], fb[-1]) if fpn.p6p7_on_c5
                       else results[-1])
            p6 = conv_nchw(fpn.p6, self.gather(src, sb, 2))
            whole += [p6, conv_nchw(fpn.p7, F.relu(p6))]
        return results + [(w, None) for w in whole]

    # -- FBNet -------------------------------------------------------------
    def conv_bn(self, m: _ConvBN, x: torch.Tensor, bands: Bands):
        x, bands = self.conv(m.conv, x, bands)
        if m.bn is not None:
            x = m.bn(x)
        return (F.relu(x) if m.relu else x), bands

    def irf(self, m: IRFBlock, x: torch.Tensor, bands: Bands):
        y, b = self.conv_bn(m.pw, x, bands)
        if m.shuffle:
            y = _channel_shuffle(y, m.pw_group)
        if m.stride < 0:          # a nearest upsample by -stride
            y = y.repeat_interleave(-m.stride, dim=2).repeat_interleave(
                -m.stride, dim=3)
            b = b.scaled(-m.stride)
        if m.dw is not None:
            y, b = self.conv_bn(m.dw, y, b)
        y, b = self.conv_bn(m.pwl, y, b)
        if m.residual:
            y = y + x
        if m.se is not None:
            se = m.se
            s = self.spatial_mean(y, b)
            s = torch.sigmoid(conv_nchw(se.fc2, F.relu(conv_nchw(se.fc1,
                                                                    s))))
            y = y * s
        return y, b

    def fbnet(self, trunk: FBNetTrunk, images: torch.Tensor, bands: Bands):
        x = images.to(trunk.compute_dtype).permute(0, 3, 1, 2)
        x, bands = self.conv_bn(trunk.first, x, bands)
        for i in range(trunk.stages.n):
            block = getattr(trunk.stages, f"block{i}")
            if block is None:
                continue
            x, bands = (self.conv_bn(block, x, bands)
                        if isinstance(block, _ConvBN)
                        else self.irf(block, x, bands))
        return [(x.permute(0, 2, 3, 1).contiguous(), bands)]


def deepest_stride(backbone) -> int:
    """The largest stride any level of the body reaches (the unit of
    ``sp_bands``)."""
    if isinstance(backbone, VGGBackbone):
        return 2 ** backbone._layers.count("M")
    if isinstance(backbone, ResNetFPNBackbone):
        backbone = backbone.body
    if isinstance(backbone, ResNetBackbone):
        s = 4
        for name in backbone.blocks:
            ds = getattr(backbone, name).downsample
            s *= 1 if ds is None else ds.stride[0]
        return s
    if isinstance(backbone, FBNetTrunk):
        s = deepest = backbone.first.conv.stride[0]
        for i in range(backbone.stages.n):
            block = getattr(backbone.stages, f"block{i}")
            if isinstance(block, _ConvBN):
                s *= block.conv.stride[0]
            elif block is not None:
                s = s * block.stride if block.stride > 0 else \
                    s // -block.stride
            deepest = max(deepest, s)
        return deepest
    raise NotImplementedError(
        f"spatial parallelism covers the VGG16, ResNet, ResNet-FPN and "
        f"FBNet bodies, not {type(backbone).__name__}")


def _body_forward(backbone, images: torch.Tensor, transport,
                  gather: bool):
    """One rank's side of ``backbone`` on ``images``: what the body
    returns, gathered or banded."""
    stride = deepest_stride(backbone)
    height = images.shape[1]
    rows = (None if isinstance(backbone, VGGBackbone)
            else math.ceil(height / stride))
    bands = Bands(height, tuple(sp_bands(height, stride, transport.world,
                                         rows)))
    lo, hi = bands.bounds[transport.rank]
    run = _Banded(transport)
    x = images[:, lo:hi]
    if isinstance(backbone, VGGBackbone):
        levels = run.vgg(backbone, x, bands)
    elif isinstance(backbone, ResNetFPNBackbone):
        levels = run.fpn(backbone.fpn, run.resnet(backbone.body, x, bands))
        levels = [(f.permute(0, 2, 3, 1).contiguous(), b)
                  for f, b in levels]
    elif isinstance(backbone, ResNetBackbone):
        levels = run.resnet(backbone, x, bands)
    else:
        levels = run.fbnet(backbone, x, bands)
    out = tuple(f if b is None or not gather else run.gather(f, b, 1)
                for f, b in levels)
    multi = isinstance(backbone, ResNetFPNBackbone) or (
        isinstance(backbone, ResNetBackbone) and backbone.return_stages)
    return out if multi else out[0]


def sp_backbone_apply(backbone, images: torch.Tensor, group=None,
                      gather: bool = True):
    """The ``backbone``'s features of ``images`` [B, H, W, 3] (the whole
    batch, the same on every rank of ``group``), each rank convolving its
    band. Returns what the body returns (one NHWC map, or a tuple of NHWC
    levels) on every rank (``gather``), or this rank's band of each banded
    level."""
    return _body_forward(backbone, images, DistTransport(group), gather)


def sp_stitch(backbone, images: torch.Tensor, world: int,
              gather: bool = True) -> list:
    """``world`` bands of a body in one process, one thread each, through
    the same band arithmetic as ``sp_backbone_apply``: [what rank r's side
    returns]."""
    stitch = _Stitch(world)
    out: List[Optional[object]] = [None] * world
    errors: List[BaseException] = []

    def side(rank):
        try:
            out[rank] = _body_forward(backbone, images,
                                      ThreadTransport(stitch, rank), gather)
        except BaseException as e:        # re-raised below
            errors.append(e)
            stitch.barrier.abort()

    threads = [threading.Thread(target=side, args=(r,))
               for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:           # the first cause, not a barrier it broke
        raise next((e for e in errors if not isinstance(
            e, threading.BrokenBarrierError)), errors[0])
    return out
