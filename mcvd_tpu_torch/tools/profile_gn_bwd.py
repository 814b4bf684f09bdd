"""Device time of `gn_fused_bwd` at every GroupNorm shape and form of one
flagship evaluation, on both of its routes (`ops.groupnorm.bwd_plans`: the
cluster launch and the split launches; `bwd_plan` picks one by size), warm
(inputs left in L2 by the call before) and cold (L2 flushed by writing a
128 MB buffer before each call), beside its bound; optionally against the
kernels of another checkout of this repo, with the attention kernels at the
main path's shapes too, timed in the same process in turns (other, this,
this, other).

    python -m mcvd_tpu_torch.tools.profile_gn_bwd [--other DIR] [--out FILE]

`DIR` is the root of another checkout (for example `git archive` of an
earlier commit, unpacked into a git-ignored directory); its port package is
imported under another name and builds its own kernels from its own
`csrc/`. Each line of output is one JSON record: per shape and dtype, ms
warm and cold of each route (and of the other tree's kernel), the route
`bwd_plan` picks, the bytes bound (x and dy read once, dx written once,
over the HBM rate) and the five-pass figure (x and dy read twice); with
`DIR`, then per attention shape and dtype the forward's and backward's ms
of both trees. Runs on the card only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

from .. import ops
from .gn_calls import form, group_norm_calls
from .profile_gn2 import HBM_BYTES_PER_S, device_ms, nvidia_smi

FORMS = {  # name: (eps, affine, adagn, act), as chip_smoke.py's
    "adagn_silu": (1e-5, False, True, True),
    "affine": (1e-6, True, False, False),
    "affine_silu": (1e-5, True, False, True),
}
FLUSH_BYTES = 128 * 2**20   # past the H100's 50 MB L2


def load_other(root: str, module: str = "ops"):
    """`module` (the `ops` package, or another) of the port package under
    `root`, imported as a package of another name (its kernels build from
    its own sources, into its own build directory)."""
    pkg = Path(root).resolve() / "mcvd_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_mcvd_tpu_torch", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{spec.name}.{module}")


def cold_ms(fn, reps: int = 20) -> float:
    """Median device time of one fn() call after writing FLUSH_BYTES, so the
    call finds none of its inputs in L2. The card sleeps between the flush
    and the timed call, so the host has enqueued the call by then and the
    events time the call, not the host's enqueue."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for i in range(reps):
        flush.fill_(float(i))
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cases(batch: int = 16):
    """(C, H, frames_last, form, G) of every GroupNorm call of one flagship
    evaluation, plus frames_last=2."""
    calls = group_norm_calls(batch=batch)
    out = sorted({(c["C"], c["H"], 1, form(c), c["num_groups"]) for c in calls})
    return out + [(64, 32, 2, "adagn_silu", 16)]


def inputs(B, C, H, N, fm, dtype, seed=0):
    eps, affine, adagn, act = FORMS[fm]
    g = torch.Generator(device="cuda").manual_seed(seed)
    CN = C * N
    x = (torch.randn(B, H, H, CN, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    x = x.permute(0, 3, 1, 2)
    dy = torch.randn(B, H, H, CN, generator=g, device="cuda").to(dtype).permute(0, 3, 1, 2)
    prm = {"gamma": None, "beta": None, "scale": None, "shift": None}
    if affine:
        prm["gamma"] = (1 + 0.1 * torch.randn(C, generator=g, device="cuda")).to(dtype)
        prm["beta"] = (0.1 * torch.randn(C, generator=g, device="cuda")).to(dtype)
    if adagn:
        ss = (0.1 * torch.randn(B, 2 * CN, generator=g, device="cuda")).to(dtype)
        prm["scale"], prm["shift"] = ss.chunk(2, dim=1)
    return x, dy, prm, eps, act


def measure(other_root=None, batch: int = 16, out=None) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_gn_bwd runs on the card: no CUDA device")
    other = load_other(other_root) if other_root else None
    card = nvidia_smi()
    records = []

    def emit(rec):
        records.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")

    GN = ops.groupnorm
    shapes = [(batch, *c) for c in cases(batch)] + [(64, 192, 64, 1, "adagn_silu", 32)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for B, C, H, N, fm, G in shapes:
            x, dy, prm, eps, act = inputs(B, C, H, N, fm, dtype)
            pargs = (prm["gamma"], prm["beta"], prm["scale"], prm["shift"], N, act)
            _, stats = GN.group_norm_fwd(x, G, eps, *pargs[:4], N, act, want_stats=True)
            cluster, split = GN.bwd_plans(B, C * N, H, H, dtype, G, N)
            fns = {"cluster": lambda: GN.group_norm_bwd(x, dy, stats, G, *pargs, p=cluster),
                   "split": lambda: GN.group_norm_bwd(x, dy, stats, G, *pargs, p=split)}
            order = ["cluster", "split", "split", "cluster"]
            if not GN.bwd_plan(B, C * N, H, H, dtype, G, N, prm["gamma"] is not None).split:
                # the calls on the cluster route: other cluster sizes too
                for size in (1, 2, 8):
                    q = GN.cluster_bwd_plan(B, C * N, H, H, dtype, G, N, size)
                    fns[f"cluster{size}"] = (lambda q=q: GN.group_norm_bwd(
                        x, dy, stats, G, *pargs, p=q))
                    order = order[:2] + [f"cluster{size}"] * 2 + order[2:]
            if other is not None:
                _, o_stats = other.groupnorm.group_norm_fwd(x, G, eps, *pargs[:4], N, act,
                                                            want_stats=True)
                fns["other"] = lambda: other.groupnorm.group_norm_bwd(x, dy, o_stats, G,
                                                                      *pargs)
                order = ["other"] + order + ["other"]
            ms = {k: {"warm": [], "cold": []} for k in fns}
            for name in order:
                ms[name]["warm"].append(device_ms(fns[name]))
                ms[name]["cold"].append(cold_ms(fns[name]))
            nb = x.numel() * x.element_size()
            rec = dict(card=card, op="gn_fused_bwd", B=B, C=C, H=H, frames_last=N, form=fm,
                       dtype=dn, picked="split" if GN.bwd_plan(
                           B, C * N, H, H, dtype, G, N, prm["gamma"] is not None).split
                       else "cluster",
                       bound_ms=1e3 * 3 * nb / HBM_BYTES_PER_S,
                       five_pass_ms=1e3 * 5 * nb / HBM_BYTES_PER_S)
            for name in fns:
                rec[f"{name}_warm_ms"] = statistics.mean(ms[name]["warm"])
                rec[f"{name}_cold_ms"] = statistics.mean(ms[name]["cold"])
            rec["turns"] = ms
            emit(rec)
    if other is not None:
        for rec in attention_vs(other, card, batch):
            emit(rec)
    return records


def attention_vs(other, card, B):
    """`attention_fwd` and `attention_bwd` of both trees at the main path's
    shapes (head dim 64), in turns."""
    A, OA = ops.attention, other.attention
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for T, h in [(1024, 2), (256, 3), (64, 4)]:
            g = torch.Generator(device="cuda").manual_seed(T)
            qkv = torch.randn(B, T, 3 * h * 64, generator=g, device="cuda").to(dtype)
            dy = torch.randn(B, T, h * 64, generator=g, device="cuda").to(dtype)
            fns = {}
            for name, M in (("this", A), ("other", OA)):
                o, lse = M.attention_packed_fwd(qkv, h, 0.125, True)
                fns[name] = {
                    "fwd": lambda M=M: M.attention_packed_fwd(qkv, h, 0.125, False),
                    "bwd": lambda M=M, o=o, lse=lse: M.attention_packed_bwd(qkv, o, lse, dy,
                                                                            h, 0.125)}
            ms = {n: {"fwd": [], "bwd": []} for n in fns}
            for name in ("other", "this", "this", "other"):
                for d in ("fwd", "bwd"):
                    ms[name][d].append(device_ms(fns[name][d]))
            yield dict(card=card, op="attention", B=B, T=T, heads=h, head_dim=64, dtype=dn,
                       **{f"{n}_{d}_ms": statistics.mean(ms[n][d]) for n in ms
                          for d in ("fwd", "bwd")}, turns=ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of another checkout to time against")
    ap.add_argument("--out", help="also append the records to this file")
    a = ap.parse_args(argv)
    measure(a.other, out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
