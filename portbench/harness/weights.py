"""Weights and draws made from the run's seed, on the device.

Each purpose gets its own stream: `seed_for(seed, *tags)` mixes the run's
seed with the tags through numpy's SeedSequence, so any seed (more than 32
bits too) gives well-separated generators, and the same seed the same
tensors.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict

import numpy as np
import torch


def seed_for(seed: int, *tags) -> int:
    words = [int(seed) % 2 ** 64, (int(seed) // 2 ** 64) % 2 ** 64]
    words += [zlib.crc32(str(t).encode()) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_for(seed, *tags))


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 weights for the parameter shapes, from one U(-1, 1) draw of all
    of them on the device: conv and dense kernels at variance scaling
    (fan_avg, scale 1; every layer, the zero-init ones too, so that each
    layer's arithmetic shows in the output), GroupNorm scales 1 + 0.1 u,
    biases 0.1 u."""
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=generator(device, seed, "weights"), device=device)
    u = u.mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = u[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            rf = math.prod(shape[2:]) if len(shape) > 2 else 1
            t.mul_(math.sqrt(3.0 / ((shape[0] + shape[1]) * rf / 2.0)))
        elif name.endswith("Norm_0.weight"):
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.1)
        out[name] = t
    return out
