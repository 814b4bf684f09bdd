"""The program under test with a fault planted, for the tests that show the
check turns `correct` false and for reading each fault's numbers on the
card (`portbench/calibrate.py`). Each is the mode's `Port` with one thing
broken underneath the timed path:

  * `unchanged`: the step leaves its state as it found it (parameters,
    moments, EMA, count; sampling: a block returns its init);
  * `half_batch`: half of the batch is left out, the mean taken over the
    rest (sampling: the second half's rows copy the first half's);
  * `ema_unchanged`: the step leaves the EMA as it found it;
  * `altered`: an answer altered where it is produced (sampling: each
    block's first predicted frame negated).

The exchange between chips does not exist in a one-chip cell.
"""

from __future__ import annotations

import torch

SAMPLE = ("unchanged", "half_batch", "altered")
TRAIN = ("unchanged", "half_batch", "ema_unchanged")


def sample_port(mode, fault: str):
    base = mode.Port

    class Faulty(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inner, C = self.block, self.config.data.channels
            if fault == "unchanged":
                self.block = lambda params, init, *rest, **kw: init
            elif fault == "altered":
                def block(*args, **kw):
                    out = inner(*args, **kw).clone()
                    out[..., :C] = -out[..., :C]
                    return out
                self.block = block

        def request(self, cond, draws):
            if fault != "half_batch":
                return super().request(cond, draws)
            half = cond.shape[0] // 2

            class Half:
                def __len__(s):
                    return len(draws)

                def __getitem__(s, k):
                    d = draws[k]
                    return {"init": d["init"][:half], "step_noise": d["step_noise"][:, :half]}

            out = super().request(cond[:half], Half())
            return torch.cat([out, out], dim=0)[:cond.shape[0]]

    if fault not in SAMPLE:
        raise ValueError(f"sampling fault {fault!r} not in {SAMPLE}")
    return Faulty


def train_port(mode, fault: str):
    base = mode.Port

    class Faulty(base):
        def step(self, X, draws, gen):
            if fault == "half_batch":
                h = X.shape[0] // 2
                return super().step(X[:h], {k: v[:h] for k, v in draws.items()}, gen)
            before = self.snapshot(("ema",) if fault == "ema_unchanged" else mode.STATE)
            m = super().step(X, draws, gen)
            self.restore(before)
            return m

    if fault not in TRAIN:
        raise ValueError(f"training fault {fault!r} not in {TRAIN}")
    return Faulty
