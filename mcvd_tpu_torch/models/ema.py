"""Exponential moving average of parameters (counterpart of
`mcvd_tpu/models/ema.py`; upstream models/ema.py EMAHelper).

The shadow is a dict of tensors shaped as the parameters. Unlike the JAX
package's pure tree map, `ema_update` updates the shadow tensors in place,
under `torch.no_grad()`, so the train step holds one copy of the weights
for the EMA and not two.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               mu: float) -> Dict[str, torch.Tensor]:
    """shadow <- mu*shadow + (1 - mu)*param for every entry, in place; returns
    `shadow`."""
    for name, s in shadow.items():
        s.mul_(mu).add_(params[name] * (1.0 - mu))
    return shadow
