"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), the one yardstick of every roofline and ``mfu`` share.

FLOP/s: 495 TFLOP/s TF32 on the tensor cores, of which 3xTF32 (three TF32
products for one float32-grade product) gets a third, 165 TFLOP/s: the
highest tier that the port's float32 policy admits (a single TF32 pass
never is).  Whatever implements the work, the same work reads the same
share, and no share can pass 100 %.

Bytes/s: 3.35 TB/s of HBM3.
"""

FLOPS = 495e12 / 3
BYTES = 3.35e12
F32 = 4  # bytes of a float32


def bound_s(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flop / FLOPS, nbytes / BYTES)
