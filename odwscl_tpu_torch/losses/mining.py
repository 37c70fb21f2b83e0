"""Contrastive pseudo-GT mining, batched over [B, C-1, P].

Counterpart of ``odwscl_tpu/losses/mining.py``:

Stage A: per (image, branch, positive class) take the top-scoring proposal
  and every proposal with IoU >= p_thres to it; the union over branches is
  the per-class bank (``a_mask``). Each member enters the bank three times:
  clean, dropblock and noise views (the caller computes the two augmented
  views on the compacted slots).
Stage B: per branch (in order: the dedup set carries over), per (image,
  positive class): threshold the max box's similarity row at its mean
  similarity to the stage-A bank, run the reference's boolean ``ge`` chain
  against the other positive classes' rows, NMS the cluster, fall back to
  the max box when empty, dedup against the bank and append the new clean
  embeddings.

Banks are compacted into fixed-capacity slots in (image, class, proposal)
order (``first_true``); what does not fit is counted as overflow.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.nms import batched_nms_mask
from ..structures.boxes import box_iou
from .compact import first_true


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
