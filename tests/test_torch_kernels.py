"""Kernels K1 (in-bucket sort) and K2 (range probe) of the port against the
JAX package's Pallas kernels and host probe.

On the CPU the port's wrappers take their plain PyTorch versions — because
the tensors lie on the CPU — and the Pallas kernels run in interpret mode, as
`tests/test_pallas_sort.py` and `tests/test_pallas_probe.py` run them.
`tests/test_torch_cuda.py` holds the CUDA kernels against the same plain
versions on a card. Outputs are integers: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.ops.bucket_join import _probe, _probe_host
from hyperspace_tpu.ops.pallas_probe import probe_pallas
from hyperspace_tpu.ops.pallas_sort import sort_padded_with_order
from hyperspace_tpu_torch.ops import cuda_probe, cuda_sort
from hyperspace_tpu_torch.telemetry import compile_log

PAD = np.iinfo(np.int64).max


def _sort_input(seed, rows, cap, low=-(2**62), high=2**62):
    rng = np.random.RandomState(seed)
    keys = rng.randint(low, high, size=(rows, cap), dtype=np.int64)
    for b in range(rows):
        keys[b, rng.randint(0, cap + 1):] = PAD
    return keys


SORT_CASES = [(0, 8, 256, -(2**62), 2**62), (1, 3, 512, -(2**62), 2**62), (2, 8, 256, 0, 5)]


@pytest.mark.parametrize("seed,rows,cap,low,high", SORT_CASES)
def test_sort_plain_matches_pallas_and_stable_argsort(seed, rows, cap, low, high):
    keys = _sort_input(seed, rows, cap, low, high)
    got_keys, got_order = cuda_sort.sort_rows(torch.from_numpy(keys))
    pallas_keys, _pallas_order = sort_padded_with_order(jnp.asarray(keys))
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(pallas_keys))
    # The bitonic Pallas network is unstable; the port's order is exactly the
    # stable argsort (what the JAX package's host build uses).
    np.testing.assert_array_equal(got_order.numpy(), np.argsort(keys, axis=1, kind="stable"))
    assert got_order.dtype == torch.int32


def _probe_input(seed, rows, cap_l, cap_r, distinct, dtype=np.int64):
    rng = np.random.RandomState(seed)
    l_len = rng.randint(0, cap_l + 1, rows)
    r_len = rng.randint(0, cap_r + 1, rows)
    l_len[0], r_len[min(1, rows - 1)] = 0, 0
    pad = np.finfo(np.float64).max if dtype == np.float64 else PAD
    ls = np.full((rows, cap_l), pad, dtype)
    rs = np.full((rows, cap_r), pad, dtype)
    for b in range(rows):
        vals_l = rng.randint(0, distinct, l_len[b]).astype(dtype)
        vals_r = rng.randint(0, distinct, r_len[b]).astype(dtype)
        if dtype == np.float64:
            vals_l, vals_r = (vals_l - distinct / 2) / 3.0, (vals_r - distinct / 2) / 3.0
        ls[b, : l_len[b]] = np.sort(vals_l)
        rs[b, : r_len[b]] = np.sort(vals_r)
    return ls, rs, l_len.astype(np.int64), r_len.astype(np.int64)


PROBE_CASES = [
    (0, 8, 256, 512, 40, np.int64),
    (1, 4, 256, 1024, 2**40, np.int64),
    (2, 8, 256, 512, 30, np.float64),
    (3, 3, 512, 512, 7, np.int64),
]


@pytest.mark.parametrize("seed,rows,cap_l,cap_r,distinct,dtype", PROBE_CASES)
def test_probe_plain_matches_pallas_and_host_probe(seed, rows, cap_l, cap_r, distinct, dtype):
    ls, rs, l_len, r_len = _probe_input(seed, rows, cap_l, cap_r, distinct, dtype)
    lo, counts = cuda_probe.range_probe(*(torch.from_numpy(a) for a in (ls, rs, l_len, r_len)))
    lo, counts = lo.numpy(), counts.numpy()
    # Exactly the JAX package's host probe, value for value.
    host_lo, host_counts = _probe_host(ls, rs, l_len, r_len)
    np.testing.assert_array_equal(lo, host_lo)
    np.testing.assert_array_equal(counts, host_counts)
    # The Pallas kernel under tests/test_pallas_probe.py's `_assert_equiv`
    # contract: counts equal everywhere, lo equal wherever a match exists.
    args = tuple(jnp.asarray(a) for a in (ls, rs, l_len, r_len))
    p_lo, p_counts = probe_pallas(*args)
    np.testing.assert_array_equal(counts, np.asarray(p_counts))
    mask = counts > 0
    np.testing.assert_array_equal(lo[mask], np.asarray(p_lo)[mask])
    x_lo, x_counts = _probe(*args)
    np.testing.assert_array_equal(counts, np.asarray(x_counts))


UNSORTED_PROBE_CASES = [
    (20, 8, 256, 512, 40, np.int64),
    (21, 4, 256, 1024, 2**40, np.int64),
    (22, 8, 256, 512, 30, np.float64),
    (23, 4, 512, 256, 9, np.int64),
    (24, 3, 512, 512, 1, np.int64),
]


@pytest.mark.parametrize("seed,rows,cap_l,cap_r,distinct,dtype", UNSORTED_PROBE_CASES)
def test_probe_plain_matches_pallas_and_host_probe_on_unsorted_left_rows(seed, rows, cap_l, cap_r, distinct, dtype):
    """K2's contract holds for ANY order of the left row (the Pallas kernel
    counts by brute force and `_probe_host` searches each key alone), so the
    plain version, which the CUDA kernel must equal, is held to it here on
    left rows shuffled within their valid prefix."""
    ls, rs, l_len, r_len = _probe_input(seed, rows, cap_l, cap_r, distinct, dtype)
    rng = np.random.RandomState(seed)
    for b in range(rows):
        rng.shuffle(ls[b, : l_len[b]])
    assert any((np.diff(ls[b, : l_len[b]]) < 0).any() for b in range(rows)) or distinct == 1
    lo, counts = cuda_probe.range_probe(*(torch.from_numpy(a) for a in (ls, rs, l_len, r_len)))
    lo, counts = lo.numpy(), counts.numpy()
    host_lo, host_counts = _probe_host(ls, rs, l_len, r_len)
    np.testing.assert_array_equal(lo, host_lo)
    np.testing.assert_array_equal(counts, host_counts)
    args = tuple(jnp.asarray(a) for a in (ls, rs, l_len, r_len))
    mask = counts > 0
    for other_lo, other_counts in (probe_pallas(*args), _probe(*args)):
        np.testing.assert_array_equal(counts, np.asarray(other_counts))
        np.testing.assert_array_equal(lo[mask], np.asarray(other_lo)[mask])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    compile_log.reset_launches(cuda_sort.LABEL, cuda_probe.LABEL)
    keys = torch.from_numpy(_sort_input(5, 4, 64))
    assert [torch.equal(a, b) for a, b in zip(cuda_sort.sort_rows(keys), cuda_sort.sort_rows_plain(keys))] == [True, True]
    args = [torch.from_numpy(a) for a in _probe_input(6, 4, 64, 128, 20)]
    assert [torch.equal(a, b) for a, b in zip(cuda_probe.range_probe(*args), cuda_probe.range_probe_plain(*args))] == [True, True]
    assert (cuda_sort.launches, cuda_probe.launches) == (0, 0)


def test_widths_and_edges_of_the_plain_versions():
    """cap 1 and 2, all-pad rows and all-duplicate rows keep the contract."""
    for cap in (1, 2):
        keys = torch.tensor([[PAD] * cap, [3] * cap], dtype=torch.int64)
        k, o = cuda_sort.sort_rows(keys)
        assert torch.equal(k, keys) and o.tolist() == [list(range(cap))] * 2
    dup = torch.full((2, 8), 9, dtype=torch.int64)
    lo, counts = cuda_probe.range_probe(dup, dup, torch.tensor([8, 0]), torch.tensor([8, 8]))
    assert lo.tolist() == [[0] * 8, [0] * 8]
    assert counts.tolist() == [[8] * 8, [0] * 8]


def test_wrappers_refuse_a_device_they_have_no_kernel_for():
    with pytest.raises(ValueError):
        cuda_sort.sort_rows(torch.empty((2, 4), dtype=torch.int64, device="meta"))
    m = torch.empty((2, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        cuda_probe.range_probe(m, m, torch.zeros(2), torch.zeros(2))


def test_build_list_names_every_kernel_source_and_nothing_else():
    """The sources and headers `_kernels` compiles and hashes into the build
    digest are exactly the `.cu`/`.cuh` files under `csrc/`: a deleted header
    left in the digest, or a source the build never compiles, fails here."""
    import os

    from hyperspace_tpu_torch.ops import _kernels

    named = _kernels._SOURCES + _kernels._HEADERS
    assert len(set(named)) == len(named)
    on_disk = {f for f in os.listdir(_kernels._CSRC) if f.endswith((".cu", ".cuh"))}
    assert set(named) == on_disk
    assert all(f.endswith(".cu") for f in _kernels._SOURCES)
    assert all(f.endswith(".cuh") for f in _kernels._HEADERS)
