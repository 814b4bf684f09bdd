"""`attention_fwd`: softmax attention over T tokens in H heads of width D,
from the shapes of one call (packed qkv in, o out).

Operations: the two products Q K^T and P V, 2 * 2 B H T^2 D (a multiply-add
is 2); the softmax's exponentials are not counted. Bytes: q, k and v read
once and o written once, 4 B T H D at the compute dtype's width (the
logsumexp the training forward also writes, 4 B H T bytes, is left out: the
sampling cells do not write it)."""

from portbench.harness.peaks import ITEMSIZE, least_seconds

KERNELS = r"attn_wg::fwd(_packed)?_kernel"
CALLS = "attention_fwd"


def work(call: dict, dtype: str):
    B, T, H, D = call["B"], call["T"], call["H"], call["D"]
    return 4 * B * H * T * T * D, 4 * B * T * H * D * ITEMSIZE[dtype]


def least(call: dict, dtype: str) -> float:
    return least_seconds(*work(call, dtype), dtype)
