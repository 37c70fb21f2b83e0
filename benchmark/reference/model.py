"""The reference detector: VGG16-OICR, 7x7 ROIPool, fc6/fc7, SimNet, MIST
heads; the contrastive training forward and the AVG eval forward.

A frozen copy of the port's ``models/vgg16.py``, ``models/sim_net.py``,
``models/predictors.py`` and ``models/detector.py`` (``train_forward``
with DropBlock and contrastive mining, ``eval_forward`` with AVG box
regression), in plain float32 (or the fp8 control, ``precision.py``),
held as a dict of parameter tensors named as the program names its own.
The random draws take the same calls, in the same order and shapes, from
the generator the caller hands in, so a generator in the window's
starting state gives the program's draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import losses as L
from .ops import (RoIPool, clip_to_image, decode_boxes, dropblock_2d,
                  noise_augment)
from .precision import Precision

VGG16_OICR = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
              512, "I", "512-D", "512-D", "512-D"]
FREEZE_CONV_COUNTS = [2, 4, 7, 10, 13]
NECK_DROPOUT = 0.5
DB_PROB, DB_SIZE = 0.3, 3
GT_CAP = 128


def param_shapes(num_classes: int, mlp_dim: int = 4096, num_refs: int = 3,
                 pooled: int = 7, spec=VGG16_OICR):
    """(name, shape) of every parameter, named as the program's."""
    out, cin, i = [], 3, 0
    for v in spec:
        if v in ("M", "I"):
            continue
        ch = int(str(v).split("-")[0])
        out += [(f"backbone.conv{i}.weight", (ch, cin, 3, 3)),
                (f"backbone.conv{i}.bias", (ch,))]
        cin, i = ch, i + 1
    dims = [("neck.fc6", mlp_dim, cin * pooled * pooled),
            ("neck.fc7", mlp_dim, mlp_dim),
            ("sim_net.mlp0", mlp_dim, mlp_dim),
            ("sim_net.mlp1", 128, mlp_dim)]
    for name, o, k in dims + [(f"pred.{h}", n, mlp_dim)
                              for h, n in heads(num_classes, num_refs)]:
        out += [(f"{name}.weight", (o, k)), (f"{name}.bias", (o,))]
    return out


def heads(num_classes: int, num_refs: int = 3):
    """The MIST predictor's heads in the order of its fused matmul."""
    out = [("cls_score", num_classes), ("det_score", num_classes)]
    for i in range(num_refs):
        out += [(f"ref{i + 1}", num_classes),
                (f"bbox_pred{i + 1}", num_classes * 4)]
    return out


# planted faults of ROIPool's backward: where each [B, H, W, C] map
# cell's gradient goes instead (one column on, the column mirrored in the
# map's width, the next image of the batch)
MISROUTES = {"shift": lambda g: torch.roll(g, 1, dims=2),
             "mirror": lambda g: torch.flip(g, dims=(2,)),
             "next_image": lambda g: torch.roll(g, 1, dims=0)}


class Detector:
    """Parameters ``params`` {name: f32 tensor}; ``s`` the settings: the
    configuration's numbers (``num_classes``, ``cap_a``, ``cap_b``,
    ``p_thres``, ``mining_nms``, ``lmda``, ``temperature``, ``fg_iou``,
    ``reg_weights``, ``pooler_scale``, ``pooled``, ``freeze_at``,
    ``num_refs``)."""

    def __init__(self, params: Dict[str, torch.Tensor], s: dict,
                 precision: Optional[Precision] = None, spec=VGG16_OICR):
        self.p = params
        self.s = s
        self.pr = precision or Precision("f32")
        self.spec = spec
        self.layers, i = [], 0
        for v in spec:
            if v == "M":
                self.layers.append("M")
            elif v != "I":
                self.layers.append((i, 2 if str(v).endswith("-D") else 1))
                i += 1
        self.num_convs = i
        frozen = FREEZE_CONV_COUNTS[s["freeze_at"] - 1] if s["freeze_at"] \
            else 0
        self.frozen = {f"backbone.conv{k}.{leaf}" for k in range(frozen)
                       for leaf in ("weight", "bias")}

    def trainable(self):
        return {n: t for n, t in self.p.items() if n not in self.frozen}

    # -- modules ---------------------------------------------------------
    def backbone(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        for layer in self.layers:
            if layer == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            i, dil = layer
            x = self.pr.conv(x, self.p[f"backbone.conv{i}.weight"],
                             self.p[f"backbone.conv{i}.bias"], dil)
            if i + 1 < self.num_convs:
                x = F.relu(x)
        return x.permute(0, 2, 3, 1).contiguous()

    def neck(self, x, keep=None):
        x = x.reshape(x.shape[0], -1)
        for li, name in enumerate(("fc6", "fc7")):
            x = F.relu(self.pr.linear(x, self.p[f"neck.{name}.weight"],
                                      self.p[f"neck.{name}.bias"]))
            if keep is not None:
                x = torch.where(keep[li], x / (1.0 - NECK_DROPOUT), 0.0)
        return x

    def draw_keep(self, n, generator, device):
        return tuple(torch.rand((n, self.p[f"neck.{fc}.weight"].shape[0]),
                                generator=generator, device=device)
                     >= NECK_DROPOUT for fc in ("fc6", "fc7"))

    def sim_net(self, x):
        h = F.relu(self.pr.linear(x, self.p["sim_net.mlp0.weight"],
                                  self.p["sim_net.mlp0.bias"]))
        z = self.pr.linear(h, self.p["sim_net.mlp1.weight"],
                           self.p["sim_net.mlp1.bias"])
        sq = (z * z).sum(dim=-1, keepdim=True).clamp(min=1e-24)
        return z * torch.rsqrt(sq)

    def pred_logits(self, x):
        hs = heads(self.s["num_classes"], self.s["num_refs"])
        w = torch.cat([self.p[f"pred.{h}.weight"] for h, _ in hs])
        b = torch.cat([self.p[f"pred.{h}.bias"] for h, _ in hs])
        return torch.split(self.pr.linear(x, w, b), [n for _, n in hs],
                           dim=-1)

    def pool(self, feats, boxes, mask):
        return RoIPool.apply(feats, boxes, mask, self.s["pooler_scale"],
                             self.s["pooled"])

    # -- forwards --------------------------------------------------------
    @torch.no_grad()
    def eval_forward(self, batch):
        """(scores [B,P,C], decoded boxes [B,P,4C]) of the AVG heuristic."""
        feats = self.backbone(batch["images"])
        pooled = self.pool(feats, batch["boxes"], batch["box_mask"])
        b, p = pooled.shape[:2]
        clean = self.neck(pooled.reshape(b * p, -1)).reshape(b, p, -1)
        outs = self.pred_logits(clean)
        refs = [torch.softmax(r, dim=-1) for r in outs[2::2]]
        scores = torch.stack(refs).mean(dim=0)
        deltas = torch.stack(list(outs[3::2])).mean(dim=0)
        dec = decode_boxes(deltas, batch["boxes"], self.s["reg_weights"])
        dec = dec.reshape(b, p, -1, 4)
        dec = clip_to_image(dec, batch["image_sizes"][:, None, None, :])
        return scores, dec.reshape(b, p, -1)

    def train_forward(self, batch, generator):
        """(losses, metrics) of one batch, as the program's contrastive
        ``train_forward`` (with ``s["pool_grad_route"]``, a planted fault:
        the gradient of the feature map moved as ``MISROUTES`` says)."""
        s = self.s
        boxes, mask, labels = (batch["boxes"], batch["box_mask"],
                               batch["labels"])
        dev = boxes.device
        losses, metrics = {}, {}
        feats = self.backbone(batch["images"])
        route = s.get("pool_grad_route")
        if route and feats.requires_grad:
            # a planted fault: ROIPool's backward routes each cell's
            # gradient to another cell, at the same norm
            feats.register_hook(MISROUTES[route])
        pooled = self.pool(feats, boxes, mask)
        b, p = pooled.shape[:2]
        flat_pooled = pooled.reshape(b * p, *pooled.shape[2:])
        clean_keep = self.draw_keep(b * p, generator, dev)
        with torch.no_grad():
            z_clean = self.sim_net(self.neck(flat_pooled, clean_keep)
                                   ).reshape(b, p, -1)
        aug_pooled = dropblock_2d(flat_pooled, DB_PROB, DB_SIZE,
                                  valid=mask.reshape(-1), generator=generator)
        aug = self.neck(aug_pooled, self.draw_keep(b * p, generator, dev))
        outs = self.pred_logits(aug.reshape(b, p, -1))
        cls, det = outs[0], outs[1]
        refs, bbox = list(outs[2::2]), list(outs[3::2])
        final = L.wsddn_final_score(cls, det, mask)
        losses["loss_img"] = L.mil_loss(final, labels)
        ref_softmax = torch.stack([torch.softmax(r, dim=-1) for r in refs])
        labels_fg = labels[:, 1:] > 0
        final_ng, ref_ng = final.detach(), ref_softmax.detach()

        cap_a, cap_b = s["cap_a"], s["cap_b"]
        a = L.stage_a(boxes, mask, labels_fg, final_ng, ref_ng, s["p_thres"],
                      cap_a)
        slot_pooled = pooled[a.slot_b.clamp(min=0), a.slot_p]
        dropped = dropblock_2d(slot_pooled, 0.3, 1, valid=a.slot_valid,
                               generator=generator)
        z_drop = self.sim_net(self.neck(dropped, self.draw_keep(
            cap_a, generator, dev)))
        noised = noise_augment(slot_pooled, generator)
        z_noise = self.sim_net(self.neck(noised, self.draw_keep(
            cap_a, generator, dev)))
        sb = L.stage_b(boxes, mask, labels_fg, final_ng, ref_ng, z_clean,
                       z_drop.detach(), z_noise.detach(), a, s["mining_nms"],
                       cap_b)
        rows = torch.cat([a.slot_b.clamp(min=0) * p + a.slot_p,
                          sb.slot_b.clamp(min=0) * p + sb.slot_p])
        bank_keep = tuple(k[rows] for k in clean_keep)
        z_bank = self.sim_net(self.neck(flat_pooled[rows], bank_keep))
        feats_e, labels_e, hard_e, valid_e = L.assemble_bank(
            a, sb, z_clean, z_drop, z_noise, z_a_clean=z_bank[:cap_a],
            z_b_clean=z_bank[cap_a:])
        losses["loss_sim"] = s["lmda"] * L.supcon_v2_loss(
            feats_e, labels_e, hard_e, valid_e, s["temperature"])
        metrics["n_bank"] = valid_e.sum().float()
        metrics["n_mined"] = sb.pgt_instance.sum().float()

        for i in range(s["num_refs"]):
            src = final_ng if i == 0 else ref_ng[i - 1]
            pl = L.od_layer(boxes, mask, src[..., 1:], labels_fg,
                            sb.pgt_instance[i], s["fg_iou"], GT_CAP,
                            s["reg_weights"])
            lam = 3.0 if i == 0 else 1.0
            losses[f"loss_ref_cls{i}"] = lam * L.refinement_cls_loss(
                refs[i], pl.labels, pl.weights, mask)
            losses[f"loss_ref_reg{i}"] = lam * L.refinement_reg_loss(
                bbox[i], pl.labels, pl.weights, pl.reg_targets, mask)
            metrics[f"n_pos{i}"] = ((pl.labels > 0) & mask).sum().float()
        return losses, metrics
