"""The reference's losses: the WSDDN MIL loss, contrastive mining (stages
A and B, the bank), SupCon v2, the ``od_layer`` pseudo-labels and the
refinement losses.

Frozen copies of the port's ``losses/weak_loss.py``, ``losses/mining.py``,
``losses/pseudo_labels.py`` and ``losses/supcon.py``, as the contrastive
recipe (``SOLVER.CONTRA``, ``loss`` supconv2) uses them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .ops import (batched_nms_mask, binary_cross_entropy, box_iou,
                  cross_entropy_with_logits, encode_boxes, first_true,
                  smooth_l1_loss)


class StageAResult(NamedTuple):
    a_mask: torch.Tensor      # [B, C-1, P] bank membership from IoU seeding
    hardness: torch.Tensor    # [B, C-1, P] score_c / sum_p score_c
    max_idx: torch.Tensor     # [R, B, C-1] per-branch top proposal
    slot_b: torch.Tensor      # [capA] image index (or -1)
    slot_c: torch.Tensor      # [capA] fg class index
    slot_p: torch.Tensor      # [capA] proposal index
    slot_valid: torch.Tensor  # [capA]
    overflow: torch.Tensor    # scalar: bank members dropped by compaction


class StageBResult(NamedTuple):
    pgt_instance: torch.Tensor  # [R, B, C-1, P] sets consumed by od_layer
    sb_mask: torch.Tensor       # [R, B, C-1, P] new clean bank entries
    slot_b: torch.Tensor        # [capB]
    slot_c: torch.Tensor
    slot_p: torch.Tensor
    slot_r: torch.Tensor        # branch of each stage-B slot
    slot_valid: torch.Tensor
    overflow: torch.Tensor


def _branch_fg_scores(final_score: torch.Tensor,
                      ref_softmax: torch.Tensor) -> torch.Tensor:
    """Branch 0 reads the WSDDN score, branch i > 0 the softmax of branch
    i - 1: [R, B, C-1, P], background dropped."""
    r = ref_softmax.shape[0]
    stacked = torch.stack([final_score] + [ref_softmax[i]
                                           for i in range(r - 1)])
    return stacked[..., 1:].permute(0, 1, 3, 2)


def _masked_argmax(scores: torch.Tensor, box_mask: torch.Tensor
                   ) -> torch.Tensor:
    return torch.where(box_mask[None, :, None, :], scores,
                       float("-inf")).argmax(dim=-1)


def _slots(mask: torch.Tensor, cap: int):
    """Compact a flattened membership mask into ``cap`` slots."""
    idx, count = first_true(mask.reshape(-1), cap)
    valid = idx >= 0
    return idx, valid, (count - valid.sum()).clamp(min=0)


def stage_a(boxes: torch.Tensor, box_mask: torch.Tensor,
            labels_fg: torch.Tensor, final_score: torch.Tensor,
            ref_softmax: torch.Tensor, p_thres: float,
            cap_a: int) -> StageAResult:
    """boxes [B, P, 4]; box_mask [B, P]; labels_fg [B, C-1] bool;
    final_score [B, P, C] (col 0 = bg); ref_softmax [R, B, P, C]."""
    b, p, _ = final_score.shape
    c1 = labels_fg.shape[1]
    scores = _branch_fg_scores(final_score, ref_softmax)           # [R,B,C-1,P]
    max_idx = _masked_argmax(scores, box_mask)                    # [R,B,C-1]
    a_mask = torch.zeros((b, c1, p), dtype=torch.bool, device=boxes.device)
    for r in range(scores.shape[0]):
        mbox = torch.gather(boxes, 1, max_idx[r][..., None].expand(b, c1, 4))
        a_mask |= box_iou(boxes, mbox).permute(0, 2, 1) >= p_thres
    a_mask &= box_mask[:, None, :] & labels_fg[:, :, None]

    fg = final_score[..., 1:].permute(0, 2, 1)                    # [B,C-1,P]
    fg = torch.where(box_mask[:, None, :], fg, 0.0)
    hardness = fg / fg.sum(dim=-1, keepdim=True).clamp(min=1e-12)

    idx, valid, overflow = _slots(a_mask, cap_a)
    safe = idx.clamp(min=0)
    slot_b = torch.where(valid, safe // (c1 * p), -1)
    slot_c = torch.where(valid, (safe // p) % c1, 0)
    slot_p = torch.where(valid, safe % p, 0)
    return StageAResult(a_mask, hardness, max_idx, slot_b, slot_c, slot_p,
                        valid, overflow)


def _cluster_nms(boxes: torch.Tensor, scores: torch.Tensor,
                 cluster: torch.Tensor, nms_iou: float,
                 cap: int) -> torch.Tensor:
    """NMS restricted to each (image, class) cluster: boxes [B, P, 4],
    scores and cluster [B, C-1, P] -> keep [B, C-1, P]. Each cluster is
    compacted to its first ``cap`` members first, as the JAX package does,
    so the NMS matrices stay [cap, cap]."""
    b, c1, p = cluster.shape
    idx, _ = first_true(cluster, cap)                             # [B,C-1,cap]
    valid = idx >= 0
    safe = idx.clamp(min=0)
    cand = torch.gather(boxes[:, None].expand(b, c1, p, 4), 2,
                        safe[..., None].expand(b, c1, cap, 4))
    keep_small = batched_nms_mask(cand, torch.gather(scores, 2, safe), valid,
                                  nms_iou)
    keep = torch.zeros((b, c1, p), dtype=torch.int64, device=boxes.device)
    keep.scatter_add_(2, safe, (keep_small & valid).long())
    return keep > 0


def stage_b(boxes: torch.Tensor, box_mask: torch.Tensor,
            labels_fg: torch.Tensor, final_score: torch.Tensor,
            ref_softmax: torch.Tensor, z_clean: torch.Tensor,
            z_drop_slots: torch.Tensor, z_noise_slots: torch.Tensor,
            a: StageAResult, nms_iou: float, cap_b: int,
            cluster_cap: int = 256) -> StageBResult:
    """z_clean [B, P, D]; z_drop_slots / z_noise_slots [capA, D], the
    augmented views of the stage-A slots."""
    b, p, _ = z_clean.shape
    c1 = labels_fg.shape[1]
    r = ref_softmax.shape[0]
    scores = _branch_fg_scores(final_score, ref_softmax)
    max_idx = _masked_argmax(scores, box_mask)

    z_slot_clean = z_clean[a.slot_b.clamp(min=0), a.slot_p]       # [capA, D]
    slot_onehot = (torch.nn.functional.one_hot(a.slot_c, c1).to(torch.float32)
                   * a.slot_valid[:, None].to(torch.float32))    # [capA,C-1]
    count_a = slot_onehot.sum(dim=0)                              # [C-1]
    z_bank_sum = z_slot_clean + z_drop_slots + z_noise_slots

    pgt_instances, sb_masks = [], []
    pgt_index = a.a_mask
    for i in range(r):
        mi = max_idx[i]                                           # [B, C-1]
        z_max = torch.gather(z_clean, 1, mi[..., None].expand(
            b, c1, z_clean.shape[2]))                              # [B,C-1,D]
        simrow = torch.einsum("bcd,bpd->bcp", z_max, z_clean)
        dots = torch.einsum("bcd,sd->bcs", z_max, z_bank_sum)
        num = torch.einsum("bcs,sc->bc", dots, slot_onehot)
        sim_thresh = num / (3.0 * count_a[None, :]).clamp(min=1e-12)

        # the reference's boolean chain: cur <- (float(cur) >= simrow[c'])
        # for each other positive class c'
        cur = simrow >= sim_thresh[..., None]
        for cq in range(c1):
            chained = cur.to(torch.float32) >= simrow[:, cq, :][:, None, :]
            is_other = torch.ones(c1, dtype=torch.bool, device=cur.device)
            is_other[cq] = False
            apply = labels_fg[:, cq][:, None, None] & is_other[None, :, None]
            cur = torch.where(apply, chained, cur)
        cur &= box_mask[:, None, :] & labels_fg[:, :, None]

        flat_keep = _cluster_nms(boxes, scores[i], cur, nms_iou, cluster_cap)
        fallback = (torch.zeros_like(cur).scatter_(2, mi[..., None], True)
                    & labels_fg[:, :, None])
        sim_close = torch.where(cur.any(dim=-1, keepdim=True), flat_keep,
                                fallback)
        pgt_instances.append(sim_close)

        new = sim_close & ~pgt_index
        new = torch.where(new.any(dim=-1, keepdim=True), new, fallback)
        sb_masks.append(new)
        pgt_index = pgt_index | new

    pgt_instance = torch.stack(pgt_instances)
    sb_mask = torch.stack(sb_masks)
    idx, valid, overflow = _slots(sb_mask, cap_b)
    safe = idx.clamp(min=0)
    per_r = b * c1 * p
    rem = safe % per_r
    return StageBResult(pgt_instance, sb_mask,
                        torch.where(valid, rem // (c1 * p), -1),
                        torch.where(valid, (rem // p) % c1, 0),
                        torch.where(valid, rem % p, 0),
                        torch.where(valid, safe // per_r, 0), valid, overflow)


def assemble_bank(a: StageAResult, sb: StageBResult, z_clean: torch.Tensor,
                  z_drop_slots: torch.Tensor, z_noise_slots: torch.Tensor,
                  z_a_clean: torch.Tensor = None,
                  z_b_clean: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """(features [E, D], labels [E], hardness [E], valid [E]) with
    E = 3 capA + capB. ``z_a_clean`` / ``z_b_clean`` supply the clean
    entries pre-gathered (the detector recomputes them with gradient);
    otherwise they are gathered from ``z_clean``."""
    if z_a_clean is None:
        z_a_clean = z_clean[a.slot_b.clamp(min=0), a.slot_p]
    if z_b_clean is None:
        z_b_clean = z_clean[sb.slot_b.clamp(min=0), sb.slot_p]
    feats = torch.cat([z_a_clean, z_drop_slots, z_noise_slots, z_b_clean])
    h_a = a.hardness[a.slot_b.clamp(min=0), a.slot_c, a.slot_p]
    h_b = a.hardness[sb.slot_b.clamp(min=0), sb.slot_c, sb.slot_p]
    hardness = torch.cat([h_a, h_a, h_a, h_b])
    labels = torch.cat([a.slot_c, a.slot_c, a.slot_c, sb.slot_c])
    valid = torch.cat([a.slot_valid] * 3 + [sb.slot_valid])
    return feats, labels, hardness, valid


class PseudoLabels(NamedTuple):
    labels: torch.Tensor       # [B, P] int64; 0 = background
    weights: torch.Tensor      # [B, P] f32
    reg_targets: torch.Tensor  # [B, P, 4]
    overflow: torch.Tensor     # scalar: GT candidates dropped by the cap


def _sequential_gt_scan(fg_scores: torch.Tensor, box_mask: torch.Tensor,
                        labels_fg: torch.Tensor,
                        pgt_instance: Optional[torch.Tensor]):
    """fg_scores [B, P, C-1]; pgt_instance [B, C-1, P] or None. Returns
    gt_mask and gt_score [B, C-1, P], the scores read after the earlier
    classes' row zeroing."""
    c1 = fg_scores.shape[2]
    cur = fg_scores
    gt_masks, gt_scores = [], []
    for c in range(c1):
        active = labels_fg[:, c]                                  # [B]
        col = torch.where(box_mask, cur[:, :, c], float("-inf"))
        onehot = torch.zeros_like(box_mask).scatter_(
            1, col.argmax(dim=-1, keepdim=True), True)
        if pgt_instance is not None:
            pi = pgt_instance[:, c, :]
            gt_c = torch.where(pi.any(dim=-1, keepdim=True), pi, onehot)
        else:
            gt_c = onehot
        gt_c = gt_c & active[:, None] & box_mask
        gt_masks.append(gt_c)
        gt_scores.append(torch.where(gt_c, cur[:, :, c], 0.0))
        # zero the max row across ALL classes, leaking into later classes
        zero_row = onehot & active[:, None]
        cur = torch.where(zero_row[:, :, None], 0.0, cur)
    return torch.stack(gt_masks, dim=1), torch.stack(gt_scores, dim=1)


def _assign(boxes: torch.Tensor, box_mask: torch.Tensor,
            gt_mask: torch.Tensor, gt_score: torch.Tensor, fg_iou: float,
            bg_strict_less: bool, gt_cap: int, reg_weights) -> PseudoLabels:
    """Compact each image's GT candidates to ``gt_cap`` slots, order them,
    IoU-assign every proposal."""
    b, c1, p = gt_mask.shape
    flat = gt_mask.reshape(b, c1 * p)
    gflat, count = first_true(flat, gt_cap)                       # [B, G]
    gvalid = gflat >= 0
    safe = gflat.clamp(min=0)
    gc = torch.where(gvalid, safe // p, 0)
    gp = torch.where(gvalid, safe % p, 0)
    gs = torch.gather(gt_score.reshape(b, -1), 1, safe)

    # rank within the class: (score desc, proposal asc); [B, i, j]
    better = ((gs[:, None, :] > gs[:, :, None])
              | ((gs[:, None, :] == gs[:, :, None])
                 & (gp[:, None, :] < gp[:, :, None])))
    srank = ((gc[:, None, :] == gc[:, :, None]) & better
             & gvalid[:, None, :]).sum(dim=2)
    key = torch.where(gvalid, gc * (gt_cap + 1) + srank, torch.iinfo(
        torch.int64).max)
    order = torch.argsort(key, dim=1, stable=True)
    gc, gp, gs, gvalid = (torch.gather(t, 1, order)
                          for t in (gc, gp, gs, gvalid))

    gt_boxes = torch.gather(boxes, 1, gp[..., None].expand(b, gt_cap, 4))
    iou = torch.where(gvalid[:, None, :], box_iou(boxes, gt_boxes), -1.0)
    assign = iou.argmax(dim=-1)                                   # [B, P]
    max_ov = torch.gather(iou, 2, assign[..., None])[..., 0]
    any_gt = gvalid.any(dim=-1, keepdim=True)
    fg = (max_ov >= fg_iou) if bg_strict_less else (max_ov > fg_iou)
    live = box_mask & any_gt
    lab = torch.where(fg & live, torch.gather(gc, 1, assign) + 1, 0)
    wgt = torch.where(live, torch.gather(gs, 1, assign), 0.0)
    matched = torch.gather(gt_boxes, 1, assign[..., None].expand(b, p, 4))
    reg = torch.where(live[..., None],
                      encode_boxes(matched, boxes, reg_weights), 0.0)
    overflow = (count - gvalid.sum(dim=-1)).clamp(min=0).sum()
    return PseudoLabels(lab, wgt, reg, overflow)


def od_layer(boxes: torch.Tensor, box_mask: torch.Tensor,
             fg_scores: torch.Tensor, labels_fg: torch.Tensor,
             pgt_instance: torch.Tensor, fg_iou: float = 0.5,
             gt_cap: int = 128,
             reg_weights=(10.0, 10.0, 5.0, 5.0)) -> PseudoLabels:
    """The paper's od_layer: pseudo-GT sets from the miner's pgt_instance
    [B, C-1, P], falling back to the top proposal; background where the max
    IoU <= fg_iou."""
    gt_mask, gt_score = _sequential_gt_scan(fg_scores, box_mask, labels_fg,
                                            pgt_instance)
    return _assign(boxes, box_mask, gt_mask, gt_score, fg_iou,
                   bg_strict_less=False, gt_cap=gt_cap,
                   reg_weights=reg_weights)


def _shifted_exp(features: torch.Tensor, valid: torch.Tensor,
                 temperature: float):
    """sim / T minus its row max over valid columns (detached), and
    exp of it with invalid columns zeroed."""
    feats = features.to(torch.float32)
    sim = feats @ feats.T / temperature
    col_valid = valid[None, :]
    row_max = torch.where(col_valid, sim, float("-inf")).amax(dim=1,
                                                               keepdim=True)
    sim = sim - row_max.detach()
    return sim, torch.where(col_valid, torch.exp(sim), 0.0)


def supcon_v2_loss(features: torch.Tensor, labels: torch.Tensor,
                   hardness: torch.Tensor, valid: torch.Tensor,
                   temperature: float = 0.2) -> torch.Tensor:
    """SupConLossV2 (``cfg.loss = 'supconv2'``): features [E, D]
    L2-normalized, labels [E], hardness [E] (detached weights), valid [E].

    loss_e = -hardness_e * log(sum_{e' same label} exp(s) /
    sum_{e'} exp(s)) over the other entries e', mean over valid entries.
    """
    hardness = hardness.detach()
    _, exp_sim = _shifted_exp(features, valid, temperature)
    valid_f = valid.to(torch.float32)
    same = (labels[:, None] == labels[None, :]) & valid[:, None] & valid[None]
    diag_exp = torch.diagonal(exp_sim)
    denom = exp_sim @ valid_f - diag_exp
    numer = torch.where(same, exp_sim, 0.0) @ valid_f - diag_exp
    safe = valid & (numer > 0) & (denom > 0)
    log_prob = torch.log(numer.clamp(min=1e-30) / denom.clamp(min=1e-30))
    per_entry = torch.where(safe, -log_prob * hardness, 0.0)
    return per_entry.sum() / valid_f.sum().clamp(min=1.0)


def wsddn_final_score(cls_logit: torch.Tensor, det_logit: torch.Tensor,
                      box_mask: torch.Tensor) -> torch.Tensor:
    """Softmax over classes times the masked softmax over proposals:
    [B, P, C] raw logits -> [B, P, C] f32, pads 0."""
    cls = torch.softmax(cls_logit.to(torch.float32), dim=-1)
    m3 = box_mask[..., None]
    det = torch.where(m3, det_logit.to(torch.float32), float("-inf"))
    m = det.amax(dim=-2, keepdim=True)
    e = torch.where(m3, torch.exp(det - m), 0.0)
    return cls * (e / e.sum(dim=-2, keepdim=True).clamp(min=1e-20))


def mil_loss(final_score: torch.Tensor, labels_img: torch.Tensor,
             epsilon: float = 1e-8) -> torch.Tensor:
    """Image-level MIL BCE: final_score [B, P, C], labels_img [B, C]."""
    img_score = final_score.sum(dim=1).clamp(epsilon, 1.0 - epsilon)
    bce = binary_cross_entropy(img_score, labels_img.clamp(0.0, 1.0))
    return bce.mean(dim=-1).mean()


def refinement_cls_loss(ref_logit: torch.Tensor, pseudo_labels: torch.Tensor,
                        weights: torch.Tensor,
                        box_mask: torch.Tensor) -> torch.Tensor:
    """Per-branch weighted CE: masked mean over each image's real
    proposals, then the mean over images."""
    ce = cross_entropy_with_logits(ref_logit.to(torch.float32), pseudo_labels)
    per = torch.where(box_mask, ce * weights.detach(), 0.0)
    denom = box_mask.sum(dim=-1).clamp(min=1)
    return (per.sum(dim=-1) / denom).mean()


def refinement_reg_loss(bbox_pred: torch.Tensor, pseudo_labels: torch.Tensor,
                        weights: torch.Tensor, reg_targets: torch.Tensor,
                        box_mask: torch.Tensor,
                        cls_agnostic: bool = False) -> torch.Tensor:
    """Smooth-L1 on the positives' own class columns, weighted by the
    pseudo-label scores, summed and divided by the real proposals."""
    b, p, _ = bbox_pred.shape
    pred = bbox_pred.to(torch.float32).reshape(b, p, -1, 4)
    if cls_agnostic:
        picked = pred[:, :, -1, :]
    else:
        idx = pseudo_labels.long().clamp(min=0)[:, :, None, None]
        picked = torch.gather(pred, 2, idx.expand(b, p, 1, 4))[:, :, 0, :]
    pos = (pseudo_labels > 0) & box_mask
    l1 = smooth_l1_loss(picked, reg_targets.detach(), beta=1.0)
    per = torch.where(pos[..., None], l1 * weights.detach()[..., None], 0.0)
    denom = box_mask.sum(dim=-1).clamp(min=1)
    return (per.sum(dim=(1, 2)) / denom).mean()
