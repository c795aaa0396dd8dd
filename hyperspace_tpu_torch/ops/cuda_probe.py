"""Batched range probe of padded join buckets: kernel K2 and its plain version.

`range_probe` replaces `hyperspace_tpu/ops/pallas_probe.py` `probe_pallas` :209
(the Pallas `_probe_kernel` :129). For each left slot s of row b it returns
`lo` = #right keys < key and `counts` = #right keys == key, over the valid
prefix `right[b, :r_len[b]]`, both int32, and 0 on left pad slots
(s >= l_len[b]) — the contract of `hyperspace_tpu/ops/bucket_join.py`
`_probe_host` :142, value for value. On a CUDA tensor it launches
`csrc/range_probe.cu`; on a CPU tensor it computes `range_probe_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..telemetry import compile_log as _compile_log
from . import _kernels

#: The launch label (K2); `launches` is its registry count (read-only).
LABEL = _compile_log.LABELS["K2"]

_WIDEN = (torch.int8, torch.int16, torch.int32)


def range_probe_plain(ls, rs, l_len, r_len) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: per-row `torch.searchsorted` over the valid
    prefix. Lengths clamp to [0, cap], as in the kernel."""
    l_len = torch.as_tensor(l_len).clamp(0, ls.shape[1])
    r_len = torch.as_tensor(r_len).clamp(0, rs.shape[1])
    lo = torch.zeros(ls.shape, dtype=torch.int32, device=ls.device)
    counts = torch.zeros(ls.shape, dtype=torch.int32, device=ls.device)
    for b, (n, m) in enumerate(zip(l_len.tolist(), r_len.tolist())):
        if n == 0 or m == 0:
            continue
        probe, build = ls[b, :n], rs[b, :m]
        left = torch.searchsorted(build, probe)
        right = torch.searchsorted(build, probe, right=True)
        lo[b, :n] = left.to(torch.int32)
        counts[b, :n] = (right - left).to(torch.int32)
    return lo, counts


def range_probe(ls, rs, l_len, r_len) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, counts) int32 [B, cap_l] of left keys [B, cap_l] probed into right
    keys [B, cap_r]; each row of `rs` sorted over its first r_len[b] slots.
    Lengths clamp to [0, cap] (on the card inside the kernel, with no sync)."""
    if ls.device.type == "cpu":
        return range_probe_plain(ls, rs, l_len, r_len)
    if ls.device.type != "cuda" or rs.device != ls.device:
        raise ValueError(f"range_probe: unsupported devices {ls.device}, {rs.device}")
    if ls.dtype in _WIDEN:
        ls = ls.to(torch.int64)
    if rs.dtype in _WIDEN:
        rs = rs.to(torch.int64)
    if ls.dtype != rs.dtype or ls.dtype not in (torch.int64, torch.float64):
        raise ValueError(f"range_probe: needs int64 or float64 keys, got {ls.dtype} and {rs.dtype}")
    if ls.dim() != 2 or rs.dim() != 2 or ls.shape[0] != rs.shape[0]:
        raise ValueError(f"range_probe: shapes {tuple(ls.shape)} and {tuple(rs.shape)}")
    if not (ls.is_contiguous() and rs.is_contiguous()):
        raise ValueError("range_probe: key matrices must be contiguous")
    rows, cap_l = ls.shape
    cap_r = rs.shape[1]
    if tuple(l_len.shape) != (rows,) or tuple(r_len.shape) != (rows,):
        raise ValueError("range_probe: l_len and r_len must be [B]")
    if rows * max(cap_l, cap_r) >= 2**31:
        raise ValueError(f"range_probe: matrix too large {tuple(ls.shape)}, {tuple(rs.shape)}")
    # The kernel reads int64 lengths, the dtype the join keeps: no conversion
    # runs on the main path. Both outputs are views of one allocation.
    l_len = l_len.to(device=ls.device, dtype=torch.int64).contiguous()
    r_len = r_len.to(device=ls.device, dtype=torch.int64).contiguous()
    lo, counts = torch.empty((2, rows, cap_l), dtype=torch.int32, device=ls.device)
    if rows == 0 or cap_l == 0:
        return lo, counts
    lib = _kernels.library()  # built before the probe: a build is no device time
    with _kernels.on_device(ls.device), _compile_log.observed_launch(LABEL, ls.device):
        fn = lib.hs_range_probe_i64 if ls.dtype == torch.int64 else lib.hs_range_probe_f64
        err = fn(
            ls.data_ptr(), rs.data_ptr(), l_len.data_ptr(), r_len.data_ptr(),
            lo.data_ptr(), counts.data_ptr(), rows, cap_l, cap_r,
            _kernels.stream(ls.device),
        )
        _kernels.check(err, "hs_range_probe")
    return lo, counts


_compile_log.launch_view(__name__, LABEL)
