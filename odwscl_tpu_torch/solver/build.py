"""Optimizer and LR schedule.

Counterpart of ``odwscl_tpu/solver/build.py``:

- SGD with momentum, torch.optim.SGD semantics (buf = m * buf + (g + wd p),
  p -= lr * buf), in two parameter groups: ``weight`` (lr, WEIGHT_DECAY)
  and ``bias`` (lr * BIAS_LR_FACTOR, WEIGHT_DECAY_BIAS). Frozen parameters
  (``requires_grad`` False: the convolutions below FREEZE_CONV_BODY_AT) are
  left out of the optimizer.
- WarmupMultiStepLR: linear (or constant) warmup from WARMUP_FACTOR over
  WARMUP_ITERS, then a factor gamma at each milestone.
- The momentum correction: when the LR changes by more than 1.1x between
  consecutive updates, the momentum buffers are scaled by new / old first.
  Phase as in the reference: the k-th update (k from 0) reads
  ``schedule(k + 1)`` and the correction pair is (k, k + 1).
- ITER_SIZE > 1 accumulates the running mean of that many gradients and
  updates once per ITER_SIZE steps; the update count (and so the LR) only
  advances on an update, as ``optax.MultiSteps`` does.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

# the LR ratio between consecutive updates above which the momentum buffers
# are rescaled (the reference trainer's 1.1)
CORRECTION_THRESHOLD = 1.1


def warmup_multistep_schedule(base_lr: float, steps: Sequence[int],
                              gamma: float = 0.1,
                              warmup_factor: float = 1.0 / 3,
                              warmup_iters: int = 500,
                              warmup_method: str = "linear"
                              ) -> Callable[[int], float]:
    """count -> LR, computed in float32 as the JAX package does."""
    f32 = np.float32
    milestones = sorted(int(s) for s in steps)

    def schedule(count: int) -> float:
        t = f32(count)
        if count >= warmup_iters:
            wf = f32(1.0)
        elif warmup_method == "constant":
            wf = f32(warmup_factor)
        else:
            alpha = np.clip(t / f32(max(warmup_iters, 1)), f32(0), f32(1))
            wf = f32(warmup_factor) * (f32(1) - alpha) + alpha
        n_decay = sum(count >= m for m in milestones)
        return float(f32(base_lr) * wf * (f32(gamma) ** f32(n_decay)))

    return schedule


class SGDMomentumCorrection(torch.optim.Optimizer):
    """SGD over the ``weight`` and ``bias`` groups with the momentum
    correction and ITER_SIZE accumulation. Each group holds its
    ``lr_factor`` and ``weight_decay``; ``count`` (updates applied) and
    ``mini_step`` (gradients accumulated) live in the groups so that
    ``state_dict`` carries them."""

    def __init__(self, params, schedule: Callable[[int], float],
                 momentum: float = 0.9, iter_size: int = 1):
        super().__init__(params, dict(lr_factor=1.0, weight_decay=0.0,
                                      count=0, mini_step=0))
        self.schedule = schedule
        self.momentum = momentum
        self.iter_size = max(int(iter_size), 1)

    @property
    def count(self) -> int:
        """Updates applied so far."""
        return self.param_groups[0]["count"]

    @torch.no_grad()
    def step(self, closure=None) -> bool:
        """Apply the gradients in ``.grad``; returns whether an update was
        made (False while ITER_SIZE is still accumulating)."""
        if self.iter_size > 1:
            n = self.param_groups[0]["mini_step"]
            for group in self.param_groups:
                for p in group["params"]:
                    st = self.state[p]
                    acc = st.get("grad_acc")
                    st["grad_acc"] = (p.grad.clone() if acc is None
                                      else (p.grad + n * acc) / (n + 1))
                group["mini_step"] = n + 1
            if n + 1 < self.iter_size:
                return False
        count = self.count
        lr, lr_prev = self.schedule(count + 1), self.schedule(count)
        ratio = max(lr / max(lr_prev, 1e-10), lr_prev / max(lr, 1e-10))
        corr = (lr / max(lr_prev, 1e-10)
                if ratio > CORRECTION_THRESHOLD and lr_prev > 1e-7
                else 1.0)
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                st = self.state[p]
                g = st.pop("grad_acc") if self.iter_size > 1 else p.grad
                if wd:
                    g = g + wd * p
                buf = st.get("momentum_buffer")
                if buf is None:
                    buf = st["momentum_buffer"] = torch.zeros_like(p)
                buf.mul_(corr).mul_(self.momentum).add_(g)
                p.add_(-(lr * group["lr_factor"]) * buf)
            group["count"] = count + 1
            group["mini_step"] = 0
        return True


def make_optimizer(cfg_solver, model: torch.nn.Module):
    """(optimizer, schedule) for the model's trainable parameters."""
    schedule = warmup_multistep_schedule(
        cfg_solver.BASE_LR, cfg_solver.STEPS, cfg_solver.GAMMA,
        cfg_solver.WARMUP_FACTOR, cfg_solver.WARMUP_ITERS,
        cfg_solver.WARMUP_METHOD)
    weights, biases = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (biases if name.endswith(".bias") else weights).append(p)
    groups = [
        dict(params=weights, lr_factor=1.0,
             weight_decay=cfg_solver.WEIGHT_DECAY),
        dict(params=biases, lr_factor=float(cfg_solver.BIAS_LR_FACTOR),
             weight_decay=cfg_solver.WEIGHT_DECAY_BIAS),
    ]
    opt = SGDMomentumCorrection(groups, schedule, cfg_solver.MOMENTUM,
                                cfg_solver.ITER_SIZE)
    return opt, schedule
