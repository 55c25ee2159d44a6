"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): HBM bandwidth and the CUDA cores' int32 and float32
rates. A roofline share is stated against these, with the card's power
limit beside it in the run's `device`."""
HBM_BYTES_S = 3.35e12
OPS_S = {"i32": 33.5e12, "f32": 67e12}


def bound_s(moved_bytes: float, ops: float, kind: str) -> float:
    """The card's least time for a call that moves `moved_bytes` and does
    `ops` operations of `kind`: the larger of the two."""
    return max(moved_bytes / HBM_BYTES_S, ops / OPS_S[kind])
