"""`attention_bwd`: the VJP of softmax attention, from the shapes of the
forward call it differentiates.

Operations: the four products the gradients need, dV = P^T dO, dP = dO V^T,
dQ = dS K and dK = dS^T Q, 4 * 2 B H T^2 D; recomputing S = Q K^T, as a
kernel that keeps no P does, is the implementation's cost and is not
counted. Bytes: q, k, v, o and dO read and dq, dk, dv written once (8 B T H D
at the compute dtype's width) and the forward's logsumexp read (4 B H T).
Its launches (the dQ and dK/dV kernels, or the packed one) are all
matched."""

from portbench.harness.peaks import ITEMSIZE, least_seconds

KERNELS = r"attn_wg::(dq|dkv|bwd_packed)_kernel"
CALLS = "attention_fwd"


def work(call: dict, dtype: str):
    B, T, H, D = call["B"], call["T"], call["H"], call["D"]
    return 8 * B * H * T * T * D, 8 * B * T * H * D * ITEMSIZE[dtype] + 4 * B * H * T


def least(call: dict, dtype: str) -> float:
    return least_seconds(*work(call, dtype), dtype)
