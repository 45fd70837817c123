"""Digital-FL payload size (paper Sec. II-B): norm scalar + d r-bit codes."""
from __future__ import annotations


def payload_bits(d: int, r: int) -> int:
    """L_m = 64 + d*r bits (norm scalar + quantized entries)."""
    return 64 + d * int(r)
