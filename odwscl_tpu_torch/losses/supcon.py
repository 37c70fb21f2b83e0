"""Supervised-contrastive losses over the mined embedding banks.

Counterpart of ``odwscl_tpu/losses/supcon.py``. The bank arrives as a
fixed-capacity slot buffer (embeddings, integer class labels, validity), so
the loss is one [E, E] masked matrix. Duplicated slots are ordinary
repeated rows; each row excludes its own diagonal term once.
"""

from __future__ import annotations

import torch


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


def supcon_loss(features: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor, temperature: float = 0.2) -> torch.Tensor:
    """Classic SupCon (``cfg.loss = 'supcon'``), log-softmax form. The
    per-entry count includes self while the sum excludes it, as upstream."""
    sim, exp_sim = _shifted_exp(features, valid, temperature)
    m = valid.to(torch.float32)
    denom = exp_sim @ m - torch.diagonal(exp_sim)
    log_prob = sim - torch.log(denom.clamp(min=1e-30))[:, None]
    same = (labels[:, None] == labels[None, :]) & valid[:, None] & valid[None]
    same_f = torch.where(same, 1.0, 0.0)
    num = (same_f * log_prob) @ m - torch.diagonal(same_f * log_prob)
    cnt = same_f @ m
    per_entry = torch.where(valid & (cnt > 0), -num / cnt.clamp(min=1.0), 0.0)
    return per_entry.sum() / m.sum().clamp(min=1.0)
