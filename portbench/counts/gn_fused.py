"""`gn_fused`: GroupNorm (+ affine) (+ AdaGN scale/shift) (+ SiLU) in one
launch, from the shapes of one call.

Bytes: x read once and y written once at the compute dtype's width, the
per-channel affine (2 C floats) and the per-example scale/shift (2 B C
floats) read once. Operations per element: the sum and the sum of squares
(3), the folded y = A x + B (2), SiLU where fused (4: exp, add, divide,
multiply); the per-group and per-channel terms are not counted. The
kernel is bound by bytes at every shape the configurations make."""

from portbench.harness.peaks import ITEMSIZE, least_seconds

KERNELS = r"gn_fused_kernel"
CALLS = "gn_fused"


def work(call: dict, dtype: str):
    n = call["B"] * call["C"] * call["H"] * call["W"]
    flops = n * (5 + (4 if call["act"] else 0))
    nbytes = 2 * n * ITEMSIZE[dtype]
    nbytes += 4 * 2 * call["C"] * call["affine"] + 4 * 2 * call["B"] * call["C"] * call["adagn"]
    return flops, nbytes


def least(call: dict, dtype: str) -> float:
    return least_seconds(*work(call, dtype), dtype)
