"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor
cores), and the roofline bound of a kernel call from the bytes it must
move (each input read once, each output written once) and the float32
operations it must do."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_ms(moved_bytes: float, ops: float) -> tuple:
    """(the least milliseconds the card could take, "bytes" or
    "operations", whichever bounds it)."""
    byte_ms = moved_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / F32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")
