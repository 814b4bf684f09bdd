"""`gn_fused_bwd`: the VJP of `gn_fused` (dx, and the affine's and AdaGN's
parameter gradients), from the shapes of the forward call it differentiates.

Bytes: x and dy read once and dx written once at the compute dtype's
width; the per-channel affine and per-example scale/shift read once and
their gradients written once (floats). Operations per element: the
recomputed normalisation (2) and SiLU's derivative where fused (6), the
two per-group reductions of dy and dy * xhat (4), and dx (4). Its launches
are the cluster kernel or the two-launch route (sums, apply) and the small
parameter-gradient launch, all matched here."""

from portbench.harness.peaks import ITEMSIZE, least_seconds

KERNELS = r"gn_bwd_(cluster|sums|apply|params)_kernel"
CALLS = "gn_fused"


def work(call: dict, dtype: str):
    n = call["B"] * call["C"] * call["H"] * call["W"]
    flops = n * (10 + (6 if call["act"] else 0))
    nbytes = 3 * n * ITEMSIZE[dtype]
    nbytes += 2 * 4 * 2 * call["C"] * call["affine"]
    nbytes += 2 * 4 * 2 * call["B"] * call["C"] * call["adagn"]
    return flops, nbytes


def least(call: dict, dtype: str) -> float:
    return least_seconds(*work(call, dtype), dtype)
