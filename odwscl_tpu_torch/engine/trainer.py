"""The train step and the iteration-based training loop.

Counterpart of ``odwscl_tpu/engine/trainer.py`` (``make_train_step``,
``do_train``): one step is the train forward, the sum of the loss dict,
the backward and the optimizer step, for any family of
``models.build_model`` (each has ``train_forward(batch, generator,
draws)``). The loop skips batches without any
image label, logs, checkpoints every ``checkpoint_period`` iterations and
at the end, and can start from a resumed iteration.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..models.detector import Batch

logger = logging.getLogger("odwscl_tpu_torch.trainer")


def train_step(model, optimizer, batch: Batch,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """One SGD step; returns {"loss", losses..., metrics...} as detached
    scalar tensors on the batch's device."""
    losses, metrics = model.train_forward(batch, generator, draws)
    total = torch.stack(list(losses.values())).sum()
    total.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return {"loss": total.detach(),
            **{k: v.detach() for k, v in losses.items()}, **metrics}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def do_train(model, optimizer, batches: Iterable[Batch],
             max_iter: int, device, generator: torch.Generator,
             checkpointer=None, checkpoint_period: int = 0,
             log_period: int = 20, start_iter: int = 0,
             timing_out: Optional[dict] = None,
             profile_iters: Optional[Tuple[int, int]] = None) -> int:
    """Train from ``start_iter`` to ``max_iter``; returns the last
    iteration.

    ``timing_out`` receives ``steps``: per iteration its wall seconds
    (``step_s``, device work synchronized), the wait for the host data
    (``data_s``) and the loss and metric values. ``profile_iters`` (first,
    last) traces those iterations with ``torch.profiler`` and adds the
    window's ``profile_wall_s``, ``device_busy_s`` and
    ``device_idle_share``.
    """
    device = torch.device(device)
    model.train()
    steps = []
    it = start_iter
    prof = None
    t_start = end = time.perf_counter()
    for batch in batches:
        if it >= max_iter:
            break
        if batch.labels is not None and float(batch.labels.sum()) == 0:
            logger.error("iteration=%d skipped: empty targets", it + 1)
            continue
        if profile_iters and it + 1 == profile_iters[0]:
            from torch.profiler import ProfilerActivity, profile
            _sync(device)
            # device activity only: recording every host op would slow the
            # steps it measures
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        data_s = time.perf_counter() - end
        logs = train_step(model, optimizer, batch.to(device), generator)
        _sync(device)
        it += 1
        values = {k: float(v) for k, v in logs.items()}
        step_s = time.perf_counter() - end
        steps.append({"iter": it, "step_s": step_s, "data_s": data_s,
                      **values})
        if prof is not None and it == profile_iters[1]:
            wall = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
            from ..utils.profiling import device_busy_seconds
            busy = device_busy_seconds(prof)
            if timing_out is not None:
                timing_out.update(profile_wall_s=wall, device_busy_s=busy,
                                  device_idle_share=1.0 - busy / wall)
            prof = None
        if not math.isfinite(values["loss"]):
            logger.error("iteration=%d: non-finite loss %s", it, values)
        if log_period and (it % log_period == 0 or it == start_iter + 1
                           or it == max_iter):
            lr = optimizer.schedule(optimizer.count)
            logger.info("iter: %d  lr: %.6f  loss: %.4f  step: %.3fs  "
                        "data: %.3fs", it, lr, values["loss"], step_s, data_s)
        if checkpointer is not None and checkpoint_period \
                and it % checkpoint_period == 0:
            checkpointer.save(it, model, optimizer, generator)
        end = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    if checkpointer is not None:
        checkpointer.save(it, model, optimizer, generator, final=True)
    total = time.perf_counter() - t_start
    logger.info("Total training time: %.1fs (%.4f s/it)", total,
                total / max(it - start_iter, 1))
    if timing_out is not None:
        timing_out["steps"] = steps
        timing_out["wall_s"] = total
    return it
