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

from . import _kernels

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0

_WIDEN = (torch.int8, torch.int16, torch.int32)


def range_probe_plain(ls, rs, l_len, r_len) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: per-row `torch.searchsorted` over the valid prefix."""
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
    keys [B, cap_r]; each row of `rs` sorted over its first r_len[b] slots."""
    if ls.device.type == "cpu":
        return range_probe_plain(ls, rs, l_len, r_len)
    global launches
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
    l_len = l_len.to(device=ls.device, dtype=torch.int32).contiguous()
    r_len = r_len.to(device=ls.device, dtype=torch.int32).contiguous()
    lo = torch.empty(ls.shape, dtype=torch.int32, device=ls.device)
    counts = torch.empty(ls.shape, dtype=torch.int32, device=ls.device)
    if rows == 0 or cap_l == 0:
        return lo, counts
    if int(l_len.max()) > cap_l or int(r_len.max()) > cap_r:
        raise ValueError("range_probe: a valid length exceeds its row")
    lib = _kernels.library()
    fn = lib.hs_range_probe_i64 if ls.dtype == torch.int64 else lib.hs_range_probe_f64
    err = fn(
        ls.data_ptr(), rs.data_ptr(), l_len.data_ptr(), r_len.data_ptr(),
        lo.data_ptr(), counts.data_ptr(), rows, cap_l, cap_r,
        torch.cuda.current_stream(ls.device).cuda_stream,
    )
    _kernels.check(err, "hs_range_probe")
    launches += 1
    return lo, counts
