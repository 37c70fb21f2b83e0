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
- The Concrete DropBlock (``cdb.*``) has its own two groups, ``cdb_weight``
  and ``cdb_bias`` (its norms' ``scale`` counts as a bias, as in the JAX
  package's labels), on ``SOLVER_CDB``'s schedule and rates. Their finished
  update is scaled by ``-DB.WEIGHT``, so they ascend the loss, weight decay
  included, as ``optax.chain(sgd, optax.scale(-w))`` does.
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
    """SGD over parameter groups with the momentum correction and ITER_SIZE
    accumulation. Each group holds its ``lr_factor``, ``weight_decay``,
    ``momentum``, the index of its LR schedule in ``schedules``
    (``schedule``) and the factor of its finished update (``scale``);
    ``count`` (updates applied) and ``mini_step`` (gradients accumulated)
    live in the groups so that ``state_dict`` carries them."""

    def __init__(self, params, schedule: Callable[[int], float],
                 momentum: float = 0.9, iter_size: int = 1,
                 schedules: Sequence[Callable[[int], float]] = ()):
        """``schedule`` is schedule 0; ``schedules`` are 1, 2, ..."""
        super().__init__(params, dict(lr_factor=1.0, weight_decay=0.0,
                                      momentum=momentum, schedule=0,
                                      scale=1.0, count=0, mini_step=0))
        self.schedule = schedule
        self.schedules = (schedule, *schedules)
        self.iter_size = max(int(iter_size), 1)

    @property
    def count(self) -> int:
        """Updates applied so far."""
        return self.param_groups[0]["count"]

    @torch.no_grad()
    def step(self, closure=None) -> bool:
        """Apply the gradients in ``.grad``; returns whether an update was
        made (False while ITER_SIZE is still accumulating). A parameter
        without a gradient (one the loss does not reach, as the SimNet
        without ``SOLVER.CONTRA``) is updated with a zero gradient, as the
        JAX package's dense gradient tree has it: weight decay and
        momentum still apply."""
        if self.iter_size > 1:
            n = self.param_groups[0]["mini_step"]
            for group in self.param_groups:
                for p in group["params"]:
                    st = self.state[p]
                    acc = st.get("grad_acc")
                    g = _grad(p)
                    st["grad_acc"] = (g.clone() if acc is None
                                      else (g + n * acc) / (n + 1))
                group["mini_step"] = n + 1
            if n + 1 < self.iter_size:
                return False
        count = self.count
        rates = [_rate_and_correction(s, count) for s in self.schedules]
        for group in self.param_groups:
            lr, corr = rates[group["schedule"]]
            wd = group["weight_decay"]
            for p in group["params"]:
                st = self.state[p]
                g = st.pop("grad_acc") if self.iter_size > 1 else _grad(p)
                if wd:
                    g = g + wd * p
                buf = st.get("momentum_buffer")
                if buf is None:
                    buf = st["momentum_buffer"] = torch.zeros_like(p)
                buf.mul_(corr).mul_(group["momentum"]).add_(g)
                update = -(lr * group["lr_factor"]) * buf
                if group["scale"] != 1.0:
                    update = update * group["scale"]
                p.add_(update)
            group["count"] = count + 1
            group["mini_step"] = 0
        return True


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _rate_and_correction(schedule: Callable[[int], float], count: int):
    """(LR of update ``count``, momentum correction factor)."""
    lr, lr_prev = schedule(count + 1), schedule(count)
    ratio = max(lr / max(lr_prev, 1e-10), lr_prev / max(lr, 1e-10))
    corr = (lr / max(lr_prev, 1e-10)
            if ratio > CORRECTION_THRESHOLD and lr_prev > 1e-7 else 1.0)
    return lr, corr


def _schedule(cfg_solver) -> Callable[[int], float]:
    return warmup_multistep_schedule(
        cfg_solver.BASE_LR, cfg_solver.STEPS, cfg_solver.GAMMA,
        cfg_solver.WARMUP_FACTOR, cfg_solver.WARMUP_ITERS,
        cfg_solver.WARMUP_METHOD)


def make_optimizer(cfg_solver, model: torch.nn.Module, cfg_solver_cdb=None,
                   cdb_weight: float = 0.01):
    """(optimizer, schedule) for the model's trainable parameters. With
    ``cfg_solver_cdb`` (``SOLVER_CDB``) the Concrete DropBlock's parameters
    ascend the loss on their own schedule, their update scaled by
    ``-cdb_weight`` (``DB.WEIGHT``); without it they are not trained."""
    schedule = _schedule(cfg_solver)
    names = {"weight": [], "bias": [], "cdb_weight": [], "cdb_bias": []}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("cdb."):
            names["cdb_bias" if leaf in ("bias", "scale")
                  else "cdb_weight"].append(p)
        else:
            names["bias" if leaf == "bias" else "weight"].append(p)
    groups = [
        dict(params=names["weight"], lr_factor=1.0,
             weight_decay=cfg_solver.WEIGHT_DECAY),
        dict(params=names["bias"],
             lr_factor=float(cfg_solver.BIAS_LR_FACTOR),
             weight_decay=cfg_solver.WEIGHT_DECAY_BIAS),
    ]
    schedules = ()
    if cfg_solver_cdb is not None:
        schedules = (_schedule(cfg_solver_cdb),)
        cdb = dict(momentum=cfg_solver_cdb.MOMENTUM, schedule=1,
                   scale=-float(cdb_weight))
        groups += [
            dict(params=names["cdb_weight"], lr_factor=1.0,
                 weight_decay=cfg_solver_cdb.WEIGHT_DECAY, **cdb),
            dict(params=names["cdb_bias"],
                 lr_factor=float(cfg_solver_cdb.BIAS_LR_FACTOR),
                 weight_decay=cfg_solver_cdb.WEIGHT_DECAY_BIAS, **cdb)]
    opt = SGDMomentumCorrection(groups, schedule, cfg_solver.MOMENTUM,
                                cfg_solver.ITER_SIZE, schedules)
    return opt, schedule
