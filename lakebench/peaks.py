"""The table of peaks and the roofline arithmetic.

Published figures of one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of
HBM bandwidth, and 67 T/s of non-tensor 32-bit operations, the float32 rate,
which stands in for integer compares (an assumption: the data sheet gives no
integer compare rate). Both assume the card's full 700 W.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def bound_seconds(nbytes: float, ops: float) -> Tuple[float, str]:
    """The least time the card could take: bytes over the bandwidth or
    operations over the scalar rate, whichever is larger, and which."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_share(bound_s: float, kernel_s: float):
    """Percent of the roofline a kernel's measured time reaches; None when
    no kernel time was read."""
    if kernel_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s
