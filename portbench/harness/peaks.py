"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit) that the benchmark's shares are taken against.

fp32 work is held to 3xTF32's rate, 495 / 3 TFLOP/s: the fastest an
implementation may compute fp32-class products under the port's rule that
fp32 stays fp32 (TF32 off), so no fp32 share can pass 100%. The CUDA cores'
67 TFLOP/s would let a 3xTF32 kernel read above it.
"""

FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at HBM bandwidth."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
