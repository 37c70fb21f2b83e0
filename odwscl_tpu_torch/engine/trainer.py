"""The train step and the iteration-based training loop.

Counterpart of ``odwscl_tpu/engine/trainer.py`` (``make_train_step``,
``do_train``): one step is the train forward, the sum of the loss dict,
the backward and the optimizer step, for any family of
``models.build_model`` (each has ``train_forward(batch, generator,
draws)``). The loop skips batches without any
image label, logs, checkpoints every ``checkpoint_period`` iterations and
at the end, and can start from a resumed iteration.

With a ``parallel.mesh.DataParallel`` the step is the data-parallel one
(each rank's backbone on its own images, the gathered maps through the
rest on every rank, the gradients averaged after the backward); it
equals one process on the global batch, and the skip of an unlabeled
batch is decided on the global batch's labels, so no rank skips alone.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..models.detector import Batch

logger = logging.getLogger("odwscl_tpu_torch.trainer")


def train_step(model, optimizer, batch: Batch,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None, dp=None
               ) -> Dict[str, torch.Tensor]:
    """One SGD step; returns {"loss", losses..., metrics...} as detached
    scalar tensors on the batch's device. With ``dp`` (a
    ``DataParallel``), ``batch`` is its ``ShardedBatch`` and ``draws``
    are the global batch's."""
    if dp is None:
        losses, metrics = model.train_forward(batch, generator, draws)
    else:
        feats = dp.gather_features(model.train_features(batch.local.images))
        losses, metrics = model.train_forward(batch.glob, generator, draws,
                                              features=feats)
    total = torch.stack(list(losses.values())).sum()
    total.backward()
    if dp is not None:
        dp.average_gradients(optimizer)
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
             profile_iters: Optional[Tuple[int, int]] = None, dp=None,
             meters=None, profile_dir: str = "") -> int:
    """Train from ``start_iter`` to ``max_iter``; returns the last
    iteration.

    ``timing_out`` receives ``steps``: per iteration its wall seconds
    (``step_s``, device work synchronized), the wait for the host data
    (``data_s``) and the loss and metric values. ``profile_iters`` (first,
    last) traces those iterations with ``torch.profiler`` (device activity
    on the card, host activity on the CPU) and, on the card, adds the
    window's ``profile_wall_s``, ``device_busy_s`` and
    ``device_idle_share``; with ``profile_dir`` the trace is written there
    as ``worker<rank>.pt.trace.json``. ``dp``: the data-parallel step
    (``train_step``). ``meters`` (``utils/logging_utils.py``'s
    ``MetricLogger`` or ``JsonlLogger``) receives each iteration's
    ``time``, ``data`` and log values, as the JAX loop's do.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    model.train()
    steps = []
    it = start_iter
    prof = None
    t_start = end = time.perf_counter()
    for batch in batches:
        if it >= max_iter:
            break
        if dp is not None:
            batch = dp.gather_batch(batch.to(device))
        labels = batch.glob.labels if dp is not None else batch.labels
        if labels is not None and float(labels.sum()) == 0:
            logger.error("iteration=%d skipped: empty targets", it + 1)
            continue
        if profile_iters and it + 1 == profile_iters[0]:
            from torch.profiler import ProfilerActivity, profile
            _sync(device)
            # device activity only on the card: recording every host op
            # would slow the steps it measures
            prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                       else ProfilerActivity.CPU])
            prof.__enter__()
            t_prof = time.perf_counter()
        data_s = time.perf_counter() - end
        logs = train_step(model, optimizer,
                          batch if dp is not None else batch.to(device),
                          generator, dp=dp)
        _sync(device)
        it += 1
        values = {k: float(v) for k, v in logs.items()}
        step_s = time.perf_counter() - end
        steps.append({"iter": it, "step_s": step_s, "data_s": data_s,
                      **values})
        if meters is not None:
            meters.update(time=step_s, data=data_s, **values)
        if prof is not None and it == profile_iters[1]:
            wall = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
            _profile_done(prof, wall, cuda, timing_out, profile_dir,
                          0 if dp is None else dp.rank)
            prof = None
        if not math.isfinite(values["loss"]):
            logger.error("iteration=%d: non-finite loss %s", it, values)
        if log_period and (it % log_period == 0 or it == start_iter + 1
                           or it == max_iter):
            lr = optimizer.schedule(optimizer.count)
            logger.info("iter: %d  lr: %.6f  loss: %.4f  step: %.3fs  "
                        "data: %.3fs%s", it, lr, values["loss"], step_s,
                        data_s, "" if meters is None else f"  {meters}")
        if checkpointer is not None and checkpoint_period \
                and it % checkpoint_period == 0:
            checkpointer.save(it, model, optimizer, generator)
        end = time.perf_counter()
    if prof is not None:     # the run ended inside the window
        prof.__exit__(None, None, None)
        _profile_done(prof, time.perf_counter() - t_prof, cuda, timing_out,
                      profile_dir, 0 if dp is None else dp.rank)
    if checkpointer is not None:
        checkpointer.save(it, model, optimizer, generator, final=True)
    total = time.perf_counter() - t_start
    logger.info("Total training time: %.1fs (%.4f s/it)", total,
                total / max(it - start_iter, 1))
    if timing_out is not None:
        timing_out["steps"] = steps
        timing_out["wall_s"] = total
    return it


def _profile_done(prof, wall: float, cuda: bool, timing_out, profile_dir,
                  rank: int) -> None:
    """Record a finished profiler window: its idle share on the card, its
    trace under ``profile_dir``."""
    if cuda and timing_out is not None:
        from ..utils.profiling import device_busy_seconds
        busy = device_busy_seconds(prof)
        timing_out.update(profile_wall_s=wall, device_busy_s=busy,
                          device_idle_share=1.0 - busy / wall)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"worker{rank}.pt.trace.json")
        prof.export_chrome_trace(path)
        logger.info("Wrote profiler trace to %s", path)
