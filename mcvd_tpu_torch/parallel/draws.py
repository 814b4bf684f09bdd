"""Random draws that do not depend on the number of ranks.

A data-parallel rank holds b of a batch's P*b rows. For its result to be the
one-process result's rows, each of its draws must be those rows of the
draw a single process makes for the whole batch, from the same generator in
the same order (the JAX package gets this from one replicated key over the
global shapes). `RowDraws(generator)` stands where a `torch.Generator` is
taken: each draw is made for the full batch, P times this rank's rows on
the first axis, and cut to this rank's rows (`collectives.rows`), so the
generator advances as in the one-process run, on every rank alike.

The port's draw sites call the functions here with whatever generator they
were given; with a `torch.Generator` (or None) each is the torch call it
names. Draws per row of a distribution per row (Gamma(k_cum[labels], 1))
gather the rows' parameters from the other ranks first: a collective, which
every rank reaches at the same draw.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import collectives
from . import dist as pdist


class RowDraws:
    """Draws of the full batch from `generator`, cut to this rank's rows."""

    def __init__(self, generator: Optional[torch.Generator]):
        if isinstance(generator, RowDraws):
            generator = generator.generator
        self.generator = generator

    def full(self, shape: Sequence[int]):
        return (pdist.world() * shape[0], *shape[1:])

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        s = collectives.rows(t.shape[0])
        return t[s]


def row_draws(generator):
    """`generator` wrapped in `RowDraws` in a group of more than one rank,
    else as it is."""
    if generator is None or isinstance(generator, RowDraws) or pdist.world() == 1:
        return generator
    return RowDraws(generator)


def _call(fn, shape, generator, **kw):
    if isinstance(generator, RowDraws):
        return generator.cut(fn(generator.full(shape), generator=generator.generator, **kw))
    return fn(tuple(shape), generator=generator, **kw)


def randn(shape, generator, *, device=None, dtype=None) -> torch.Tensor:
    return _call(torch.randn, shape, generator, device=device, dtype=dtype)


def rand(shape, generator, *, device=None, dtype=None) -> torch.Tensor:
    return _call(torch.rand, shape, generator, device=device, dtype=dtype)


def randint(high: int, shape, generator, *, device=None) -> torch.Tensor:
    if isinstance(generator, RowDraws):
        return generator.cut(torch.randint(0, high, generator.full(shape),
                                           generator=generator.generator, device=device))
    return torch.randint(0, high, tuple(shape), generator=generator, device=device)


def standard_gamma(concentration: torch.Tensor, generator) -> torch.Tensor:
    """Gamma(concentration, 1) per element; with `RowDraws` the other ranks'
    concentrations are gathered first (a collective)."""
    if isinstance(generator, RowDraws):
        conc = collectives.gather_rows(concentration.contiguous())
        return generator.cut(torch._standard_gamma(conc, generator=generator.generator))
    return torch._standard_gamma(concentration, generator=generator)
