"""Random detector weights from ``--seed``, made on the device in one draw.

The program and the plain reference name their parameters alike
(``backbone.conv<i>``, ``neck.fc6``/``fc7``, ``sim_net.mlp0``/``mlp1``,
``pred.<head>``), so both get the same values from ``make_weights`` on the
same (name, shape) list. One normal draw of every element, in the order of
the sorted names, from a ``torch.Generator`` on the device; each weight is
then scaled by its fan-in so that activations stay O(1) through the
network and the heads' logits are O(1) (softmaxes neither uniform nor
saturated). Biases are zero.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

# the first conv reads BGR*255 - mean pixels (magnitude ~100): scale it
# down to unit inputs
_PIXEL_SCALE = 128.0


def _std(name: str, shape: Tuple[int, ...]) -> float:
    """The weight's standard deviation by its name and fan-in."""
    fan_in = math.prod(shape[1:])
    if name.startswith("pred.") or name == "sim_net.mlp1.weight":
        return 1.0 / math.sqrt(fan_in)
    std = math.sqrt(2.0 / fan_in)
    if name == "backbone.conv0.weight":
        std /= _PIXEL_SCALE
    return std


def make_weights(specs: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for ``specs`` (name, shape): weights normal with
    ``_std``, biases 0."""
    specs = sorted((n, tuple(s)) for n, s in specs)
    weights = [(n, s) for n, s in specs if not n.endswith(".bias")]
    total = sum(math.prod(s) for _, s in weights)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in weights:
        k = math.prod(shape)
        out[name] = flat[at:at + k].view(shape).mul_(_std(name, shape))
        at += k
    for name, shape in specs:
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=device)
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, seed: int) -> None:
    """Overwrite every parameter of ``model`` with ``make_weights``."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    made = make_weights(((n, p.shape) for n, p in params.items()), seed,
                        device)
    for name, p in params.items():
        p.copy_(made[name])
