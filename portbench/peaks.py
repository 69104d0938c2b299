"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its full
700 W; the run prints the card's power limit beside its numbers).

Memory: 3.35 TB/s of HBM3. Operations: the tensor-core rate of the
storage type's matmul inputs, TF32 for float32 (a float32-accurate
split-precision product can pass float32's 67 TFLOP/s outside the tensor
cores, so that rate could not bound a share), bfloat16's for bfloat16, and
the FP64 tensor cores' for float64.
"""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 495e12, "bfloat16": 989e12, "float64": 67e12}


def bound_s(work: dict, dtype: str) -> float:
    """The least time the card could take for `work` ({"bytes", "flops"}):
    the larger of its bytes over the memory rate and its operations over
    the peak rate."""
    return max(work["bytes"] / HBM_BYTES_PER_S, work["flops"] / FLOPS_PER_S[dtype])
