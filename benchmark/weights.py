"""Weights made from the run's seed, on the device, in one draw: every
weight ``N(0, (gain * sqrt(2 / fan_in))^2)`` (Kaiming's fan-in normal
times the configuration's ``gain``), every other leaf ``N(0,
bias_std^2)``, except the leaves that ``ones`` and ``zeros`` name by the
end of their names (batch norm's scale and shift, running statistics).
The same seed and stream give the same weights; the program and the
reference are handed the same state dict."""
from __future__ import annotations

import math

import numpy as np
import torch


def make(shapes: dict, init: dict, seed: int, device, stream: int = 0
         ) -> dict:
    """``{name: float32 tensor}`` for ``shapes`` (``{name: shape}``, OIHW
    or ``[out, in]`` weights and 1-D leaves), drawn from a
    ``torch.Generator`` on ``device`` seeded from ``(seed, stream)``."""
    sizes = [math.prod(s) for s in shapes.values()]
    scale = []
    for shape in shapes.values():
        if len(shape) > 1:
            scale.append(init['gain'] * math.sqrt(2.0 / math.prod(shape[1:])))
        else:
            scale.append(init['bias_std'])
    s = int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0]) >> 1
    gen = torch.Generator(device=device).manual_seed(s)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(torch.tensor(scale, device=device).repeat_interleave(
        torch.tensor(sizes, device=device)))
    out = {name: part.view(shape) for (name, shape), part in
           zip(shapes.items(), flat.split(sizes))}
    for name, t in out.items():
        if name.endswith(tuple(init.get('ones', ()))):
            t.fill_(1.0)
        elif name.endswith(tuple(init.get('zeros', ()))):
            t.zero_()
    return out
