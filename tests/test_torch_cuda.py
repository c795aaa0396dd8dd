"""The port's CUDA kernels against their plain PyTorch versions, on a card.

K1 (`ops/cuda_sort.sort_rows`), K2 (`ops/cuda_probe.range_probe`), K3
(`ops/cuda_comp_sort`), K4 (`ops/cuda_packed_sort`) and K5 (`ops/cuda_packed_probe`) have no
CPU mode: these tests are marked `cuda` and skip where no CUDA device is
visible. They import neither jax nor the JAX package, so on a machine with a
card they run without the repo's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Outputs are integers: tolerance 0.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu_torch.ops import cuda_probe, cuda_sort

PAD = np.iinfo(np.int64).max


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sort_input(seed, rows, cap, kind="hash"):
    """A padded key matrix: random keys with a duplicate run in row 0
    ("hash"), one key everywhere so that only stability orders the row
    ("dup"), int64's ends and their neighbours ("extreme"), or pads only
    ("allpad"); every row but the last ends in pads at a random length."""
    rng = np.random.RandomState(seed)
    if kind == "dup":
        keys = np.full((rows, cap), 7, np.int64)
    elif kind == "extreme":
        ends = np.array([-(2**63), -(2**63) + 1, -1, 0, 2**63 - 2], np.int64)
        keys = rng.choice(ends, size=(rows, cap))
    else:
        keys = rng.randint(-(2**62), 2**62, size=(rows, cap), dtype=np.int64)
        keys[0, : cap // 2] = 5  # a duplicate run: ties resolve by slot
    for b in range(rows - 1):
        keys[b, rng.randint(0, cap + 1):] = PAD
    if kind == "allpad":
        keys[:] = PAD
    return keys


def _probe_input(seed, rows, cap_l, cap_r, distinct, dtype, kind="sorted"):
    """Padded left/right matrices, each right row sorted over its valid prefix.
    Left rows are sorted ("sorted"), shuffled ("shuffled": a tile's window
    spans the whole row), or hold keys below and above every right key at
    their two ends ("ends"); "hot" puts one key everywhere, so the right run
    is wider than the kernel's staged window; "allpad_tiles" leaves every left
    slot from 2049 on a pad, so whole tiles are pads."""
    rng = np.random.RandomState(seed)
    l_len = rng.randint(0, cap_l + 1, rows)
    r_len = rng.randint(0, cap_r + 1, rows)
    l_len[0], r_len[min(1, rows - 1)] = 0, 0
    if kind == "allpad_tiles":
        l_len[1:] = rng.randint(0, 2050, rows - 1)
    pad = np.finfo(np.float64).max if dtype == np.float64 else PAD
    ls = np.full((rows, cap_l), pad, dtype)
    rs = np.full((rows, cap_r), pad, dtype)
    for b in range(rows):
        vals_l = np.sort(rng.randint(0, distinct, l_len[b])).astype(dtype)
        vals_r = np.sort(rng.randint(0, distinct, r_len[b])).astype(dtype)
        if dtype == np.float64:  # keys of both signs
            vals_l, vals_r = (vals_l - distinct / 2) / 3.0, (vals_r - distinct / 2) / 3.0
        if kind == "hot":
            vals_l[:], vals_r[:] = 7, 7
        if kind == "ends" and l_len[b] >= 2:
            vals_l[0], vals_l[-1] = -(2**40), 2**40
        if kind == "shuffled":
            rng.shuffle(vals_l)
        ls[b, : l_len[b]] = vals_l
        rs[b, : r_len[b]] = vals_r
    return ls, rs, l_len.astype(np.int64), r_len.astype(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hash", "dup", "extreme", "allpad"])
@pytest.mark.parametrize(
    "rows,cap",
    # 8 and 16: a thread's pairs and two threads'; 4096 and 8192: the two
    # tiles; 16384, 32768 and 131072: one, two and four merge passes.
    [(3, 1), (5, 2), (9, 8), (4, 16), (6, 32), (8, 256), (3, 4096), (3, 8192), (4, 16384), (3, 32768),
     (2, 65536), (2, 131072)],
)
def test_sort_kernel_equals_plain(cuda_device, rows, cap, kind):
    keys = torch.from_numpy(_sort_input(rows + cap, rows, cap, kind)).to(cuda_device)
    before = cuda_sort.launches
    got, want = cuda_sort.sort_rows(keys), cuda_sort.sort_rows_plain(keys)
    assert cuda_sort.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "seed,rows,cap_l,cap_r,distinct,dtype,kind",
    [
        (0, 8, 256, 512, 40, np.int64, "sorted"),
        (1, 4, 256, 1024, 2**40, np.int64, "sorted"),
        (2, 8, 256, 512, 30, np.float64, "sorted"),
        (3, 3, 512, 512, 7, np.int64, "sorted"),
        (4, 4, 1024, 32768, 500, np.int64, "sorted"),
        # The windowed probe: main-path caps, unsorted left rows, a hot key
        # over a right row wider than the stage, all-pad tiles, windows at the
        # row's ends, float64 keys of both signs, cap_l > cap_r, odd caps.
        (5, 4, 8192, 32768, 2**20, np.int64, "sorted"),
        (6, 4, 4096, 32768, 2**20, np.float64, "sorted"),
        (7, 4, 8192, 32768, 2**20, np.int64, "shuffled"),
        (8, 3, 4096, 32768, 5000, np.float64, "shuffled"),
        (9, 2, 1024, 65536, 1, np.int64, "hot"),
        (10, 5, 8192, 32768, 2**20, np.int64, "allpad_tiles"),
        (11, 4, 8192, 32768, 2**20, np.int64, "ends"),
        (12, 4, 8192, 32768, 2**20, np.float64, "ends"),
        (13, 3, 32768, 4096, 2**16, np.int64, "sorted"),
        (14, 4, 8192, 1024, 300, np.float64, "shuffled"),
        (15, 3, 1000, 3001, 2000, np.int64, "sorted"),
        (16, 3, 3001, 1000, 2000, np.int64, "shuffled"),
    ],
)
def test_probe_kernel_equals_plain(cuda_device, seed, rows, cap_l, cap_r, distinct, dtype, kind):
    args = [torch.from_numpy(a).to(cuda_device) for a in _probe_input(seed, rows, cap_l, cap_r, distinct, dtype, kind)]
    before = cuda_probe.launches
    got, want = cuda_probe.range_probe(*args), cuda_probe.range_probe_plain(*args)
    assert cuda_probe.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    with pytest.raises(ValueError):
        cuda_sort.sort_rows(torch.zeros((2, 6), dtype=torch.int64, device=cuda_device))  # cap not pow2
    with pytest.raises(ValueError):
        cuda_sort.sort_rows(torch.zeros((2, 8), dtype=torch.float64, device=cuda_device))
    m = torch.zeros((2, 8), dtype=torch.float32, device=cuda_device)
    lens = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        cuda_probe.range_probe(m, m, lens, lens)


def _comp_input(seed, rows, n, n_pad, num_buckets=200, card=5):
    """Build composites as `partition.packed_build_sort` packs them."""
    from hyperspace_tpu_torch.engine.packed_codes import bits_for_cardinality
    from hyperspace_tpu_torch.ops.partition import packed_build_comp

    rng = np.random.RandomState(seed)
    bits = bits_for_cardinality(card)
    parts = []
    for _ in range(rows):
        b = torch.from_numpy(rng.randint(0, num_buckets, n).astype(np.int32))
        codes = torch.from_numpy(rng.randint(-1, card, n).astype(np.int32))
        parts.append(packed_build_comp(b, codes, bits, n_pad.bit_length() - 1, n_pad, num_buckets))
    return torch.cat(parts)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,n_pad", [(1, 1, 2), (1, 0, 8), (3, 900, 1024), (2, 32768, 32768),
                                          (2, 40000, 65536), (1, 150000, 262144)])
def test_comp_sort_kernel_equals_plain(cuda_device, rows, n, n_pad):
    from hyperspace_tpu_torch.ops import cuda_comp_sort

    v = _comp_input(rows + n, rows, n, n_pad).to(cuda_device)
    before = cuda_comp_sort.launches
    got, want = cuda_comp_sort.sort_comp_rows(v), cuda_comp_sort.sort_comp_rows_plain(v)
    assert cuda_comp_sort.launches == before + 1
    assert torch.equal(got, want)


def _packed_rows(seed, rows, cap, bits, sort, kind="random"):
    """Packed rows of biased lanes below the top value, then pads (the top
    value) from a random length on; row 0 is all pads and the last row has
    none. "one": one lane value fills each row; "every": each row starts with
    every lane value, the top one too."""
    from hyperspace_tpu_torch.engine.packed_codes import pack_rows

    rng = np.random.RandomState(seed)
    top = (1 << bits) - 1
    lanes = rng.randint(0, top, size=(rows, cap))
    if kind == "one":
        lanes[:] = rng.randint(0, top + 1, size=(rows, 1))
    lens = rng.randint(0, cap + 1, rows)
    lens[0] = 0
    lens[-1] = cap
    for b in range(rows):
        if kind == "every" and cap > top:
            lanes[b, : top + 1] = np.arange(top + 1)
        if sort:
            lanes[b, : lens[b]] = np.sort(lanes[b, : lens[b]])
        lanes[b, lens[b]:] = top
    return pack_rows(torch.from_numpy(lanes), bits), torch.from_numpy(lens)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "one", "every"])
@pytest.mark.parametrize(
    "bits,rows,cap",
    # A row of one word at each width; rows of up to 32768 slots are staged
    # in shared memory, longer ones (up to 2^20 at 1 bit) are not.
    [(4, 3, 8), (2, 4, 16), (1, 2, 32), (4, 64, 4096), (2, 8, 4096), (1, 8, 4096), (4, 4, 32768),
     (4, 2, 65536), (4, 2, 131072), (1, 2, 1 << 20)],
)
def test_packed_sort_kernel_equals_plain(cuda_device, bits, rows, cap, kind):
    from hyperspace_tpu_torch.ops import cuda_packed_sort

    words = _packed_rows(bits + rows + cap, rows, cap, bits, sort=False, kind=kind)[0].to(cuda_device)
    before = cuda_packed_sort.launches
    got, want = cuda_packed_sort.sort_codes_packed(words, bits), cuda_packed_sort.sort_codes_packed_plain(words, bits)
    assert cuda_packed_sort.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bits,rows,cap_l,cap_r", [(4, 3, 8, 8), (2, 5, 16, 64), (1, 4, 256, 256),
                                                   (4, 64, 4096, 4096), (4, 8, 4096, 131072)])
def test_packed_probe_kernel_equals_plain(cuda_device, bits, rows, cap_l, cap_r):
    from hyperspace_tpu_torch.ops import cuda_packed_probe

    lw, l_len = _packed_rows(bits + cap_l, rows, cap_l, bits, sort=True)
    rw, r_len = _packed_rows(bits + cap_r + 1, rows, cap_r, bits, sort=True)
    args = [t.to(cuda_device) for t in (lw, rw)] + [bits] + [t.to(cuda_device) for t in (l_len, r_len)]
    before = cuda_packed_probe.launches
    got, want = cuda_packed_probe.probe_packed(*args), cuda_packed_probe.probe_packed_plain(*args)
    assert cuda_packed_probe.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_packed_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    from hyperspace_tpu_torch.ops import cuda_comp_sort, cuda_packed_probe, cuda_packed_sort

    with pytest.raises(ValueError):
        cuda_comp_sort.sort_comp_rows(torch.zeros((1, 6), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        cuda_packed_sort.sort_codes_packed(torch.zeros((2, 3), dtype=torch.int32, device=cuda_device), 4)
    with pytest.raises(ValueError):
        cuda_packed_sort.sort_codes_packed(torch.zeros((2, 4), dtype=torch.int32, device=cuda_device), 3)
    w = torch.zeros((2, 4), dtype=torch.int32, device=cuda_device)


@pytest.mark.cuda
def test_probe_kernels_clamp_lengths_to_the_row(cuda_device):
    """Lengths past the row or below 0 clamp to [0, cap] inside K2 and K5,
    as in their plain versions; the wrappers read no length back."""
    from hyperspace_tpu_torch.ops import cuda_packed_probe

    ls, rs, _l, _r = _probe_input(9, 4, 64, 128, 50, np.int64)
    l_len = torch.tensor([64 + 9, -3, 17, 64], device=cuda_device)
    r_len = torch.tensor([128 + 1, 40, -1, 1000], device=cuda_device)
    args = [torch.from_numpy(ls).to(cuda_device), torch.from_numpy(rs).to(cuda_device), l_len, r_len]
    got, want = cuda_probe.range_probe(*args), cuda_probe.range_probe_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for bits in (1, 2, 4):
        lw, _ = _packed_rows(bits, 4, 64, bits, sort=True)
        rw, _ = _packed_rows(bits + 1, 4, 128, bits, sort=True)
        pargs = [lw.to(cuda_device), rw.to(cuda_device), bits, l_len, r_len]
        got = cuda_packed_probe.probe_packed(*pargs)
        want = cuda_packed_probe.probe_packed_plain(*pargs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _int32_keys(seed, rows, cap, kind):
    """[rows, cap] int32 keys of any sign: uniform over int32, a few
    duplicated values around 0, the int32 ends, or one value everywhere."""
    rng = np.random.RandomState(seed)
    lo, hi = -(2**31), 2**31 - 1
    if kind == "wide":
        v = rng.randint(lo, hi + 1, size=(rows, cap), dtype=np.int64)
    elif kind == "dup":
        v = rng.randint(-3, 4, size=(rows, cap))
    elif kind == "extreme":
        v = rng.choice(np.array([lo, lo + 1, -1, 0, 1, hi - 1, hi]), size=(rows, cap))
    else:
        v = np.full((rows, cap), hi)
    return torch.from_numpy(v.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cap,kind", [(4, 65536, "wide"), (4, 65536, "dup"), (3, 1024, "wide"),
                                           (3, 2048, "extreme"), (2, 4096, "dup"), (4, 8192, "allpad"),
                                           (5, 1, "wide"), (2, 1 << 20, "dup"), (1, 1 << 23, "wide")])
def test_comp_sort_kernel_sorts_any_int32(cuda_device, rows, cap, kind):
    """K3 sorts keys of any sign, duplicates and the int32 ends, in rows below,
    at and across the radix tile (2048 keys; 4096 from 2^21 keys a matrix),
    and one row of 2^23 keys."""
    from hyperspace_tpu_torch.ops import cuda_comp_sort

    v = _int32_keys(rows + cap, rows, cap, kind).to(cuda_device)
    before = cuda_comp_sort.launches
    got, want = cuda_comp_sort.sort_comp_rows(v), cuda_comp_sort.sort_comp_rows_plain(v)
    assert cuda_comp_sort.launches == before + 1
    assert torch.equal(got, want)


def _lane_table_rows(seed, rows, cap_l, cap_r, bits, kind):
    """Sorted packed left and right rows whose lanes stress K5's lane table:
    one value per right row, left lanes the right row never holds, every lane
    value (the top one too), or two values."""
    from hyperspace_tpu_torch.engine.packed_codes import pack_rows

    rng = np.random.RandomState(seed)
    top = (1 << bits) - 1
    l_len, r_len = rng.randint(0, cap_l + 1, rows), rng.randint(0, cap_r + 1, rows)
    L, R = np.full((rows, cap_l), top), np.full((rows, cap_r), top)
    for b in range(rows):
        n, m = l_len[b], r_len[b]
        if kind == "single":
            R[b, :m], L[b, :n] = rng.randint(0, top + 1), rng.randint(0, top + 1, n)
        elif kind == "absent":
            R[b, :m] = 2 * rng.randint(0, (top + 1) // 2, m)
            L[b, :n] = 2 * rng.randint(0, (top + 1) // 2, n) + 1
        elif kind == "every":
            if m > top:
                R[b, :m] = np.concatenate([np.arange(top + 1), rng.randint(0, top + 1, m - top - 1)])
            L[b, :n] = rng.randint(0, top + 1, n)
        else:
            pair = rng.choice(top + 1, 2, replace=False)
            R[b, :m], L[b, :n] = rng.choice(pair, m), rng.choice(pair, n)
        L[b, :n].sort()
        R[b, :m].sort()
    lw, rw = pack_rows(torch.from_numpy(L), bits), pack_rows(torch.from_numpy(R), bits)
    return lw, rw, torch.from_numpy(l_len), torch.from_numpy(r_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("kind", ["single", "absent", "every", "dups"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_packed_probe_kernel_lane_table_cases(cuda_device, bits, kind, dtype):
    """K5's lane table against the plain probe, with lengths in the dtype
    they arrive in (int64 from the reps, or int32); the second shape's rows
    span several blocks of left words."""
    from hyperspace_tpu_torch.ops import cuda_packed_probe

    for rows, cap_l, cap_r in [(6, 256, 1024), (3, 32768, 4096)]:
        lw, rw, l_len, r_len = _lane_table_rows(bits + rows, rows, cap_l, cap_r, bits, kind)
        args = [lw.to(cuda_device), rw.to(cuda_device), bits, l_len.to(cuda_device, dtype), r_len.to(cuda_device, dtype)]
        before = cuda_packed_probe.launches
        got, want = cuda_packed_probe.probe_packed(*args), cuda_packed_probe.probe_packed_plain(*args)
        assert cuda_packed_probe.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True], ids=["one-schema", "mixed-widths"])
def test_a_cold_multi_file_scan_on_the_card_equals_the_cpu_scan(cuda_device, tmp_path, mixed):
    """A cold scan copies each column to the card once for all its files and
    splits it into per-file tables (`io._to_device_batched`, card only). The
    tables equal the CPU read's, uncached and from the cache, with dictionary
    strings and nulls, over files of one schema (one conversion a column) and
    of mixed integer widths (a conversion a file)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.engine import io as torch_io
    from hyperspace_tpu_torch.engine import scan_cache

    rng = np.random.RandomState(3)
    paths = []
    for i in range(5):
        n = 500 + 100 * i
        k = pa.array(np.arange(n) + 1000 * i, pa.int32() if mixed and i == 2 else pa.int64())
        s = pa.array(np.array(["AIR", "MAIL", "SHIP"])[rng.randint(0, 3, n)])
        v = pa.array([None if x < 0.2 else x for x in rng.rand(n)] if i % 2 else rng.rand(n), pa.float64())
        paths.append(str(tmp_path / f"part-{i:05d}.parquet"))
        pq.write_table(pa.table({"k": k, "s": s, "v": v}), paths[-1], row_group_size=300)
    for cols in (None, ["s", "k"]):
        want = torch_io.read_files(paths, "parquet", cols, "cpu")
        scan_cache.clear_scan_caches()
        for got in (torch_io.read_files(paths, "parquet", cols, cuda_device),
                    torch_io.read_files(paths, "parquet", cols, cuda_device)):
            assert got.column_names == want.column_names
            for n in want.column_names:
                a, b = got.column(n), want.column(n)
                assert a.data.device.type == "cuda" and a.dtype == b.dtype
                assert torch.equal(a.data.cpu(), b.data)
                assert (a.validity is None) == (b.validity is None)
                assert a.validity is None or torch.equal(a.validity.cpu(), b.validity)
                assert a.dictionary is None or np.array_equal(a.dictionary, b.dictionary)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dups", "disjoint", "extremes", "large"])
def test_the_general_join_on_the_card_equals_host_merge_pairs(cuda_device, case):
    """`merge_join_pairs` (torch sorts, searchsorted and the expansion on the
    card) against the numpy merge, pairs in order."""
    from hyperspace_tpu_torch.ops.join import host_merge_pairs, merge_join_pairs

    rng = np.random.RandomState(3)
    lk, rk = {
        "dups": (rng.randint(0, 50, 30000), rng.randint(0, 60, 5000)),
        "disjoint": (rng.randint(0, 50, 3000), rng.randint(100, 150, 3000)),
        "extremes": (np.array([-(2**63), -1, 0, 2**63 - 1] * 500), np.array([2**63 - 1, 0, -(2**63), 5] * 70)),
        "large": (rng.randint(-(2**62), 2**62, 2_000_000, dtype=np.int64) % 1_000_003,
                  rng.randint(0, 1_000_003, 400_000)),
    }[case]
    lk, rk = lk.astype(np.int64), rk.astype(np.int64)
    li, ri = merge_join_pairs(torch.from_numpy(lk).to(cuda_device), torch.from_numpy(rk).to(cuda_device))
    assert li.is_cuda and ri.is_cuda
    want_l, want_r = host_merge_pairs(lk, rk)
    np.testing.assert_array_equal(li.cpu().numpy(), want_l)
    np.testing.assert_array_equal(ri.cpu().numpy(), want_r)


def _order_table(device, n=20000, dtype=np.float64):
    from hyperspace_tpu_torch.engine.table import Column, Table

    rng = np.random.RandomState(8)
    pool = np.array([np.nan, -np.nan, 0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 2.0, -2.0], dtype=dtype)
    f = pool[rng.randint(0, len(pool), n)]
    g = rng.randint(0, 3, n).astype(np.int64)
    valid = rng.rand(n) >= 0.1
    cols = {
        "f": Column.from_values(f, device),
        "g": Column.from_values(g, device),
        "fn": Column(str(f.dtype), torch.from_numpy(np.where(valid, f, 0)).to(device), None,
                     torch.from_numpy(valid).to(device)),
    }
    return Table(cols), f, g, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_order_by_on_the_card_equals_np_lexsort_with_nan_and_signed_zeros(cuda_device, dtype):
    """`OrderByExec`'s stable sorts on the card give `np.lexsort`'s order with
    the JAX package's lanes: signed zeros tie, NaNs tie after +inf, a
    descending key is a negated dense rank, nulls first ascending and last
    descending."""
    from hyperspace_tpu_torch.engine.physical import OrderByExec

    t, f, g, valid = _order_table(cuda_device, dtype=dtype)
    rank = np.unique(f, return_inverse=True)[1].reshape(-1)
    fill = np.where(valid, f, 0)
    fill_rank = np.unique(fill, return_inverse=True)[1].reshape(-1)
    cases = [
        ([("f", True)], [f]),
        ([("f", False)], [-rank]),
        ([("g", True), ("f", False)], [-rank, g]),
        ([("f", False), ("g", True)], [g, -rank]),
        ([("fn", True)], [fill, valid]),
        ([("fn", False), ("g", False)], [-g, -fill_rank, ~valid]),
    ]
    for keys, lanes in cases:
        perm = OrderByExec(keys, None).order(t)
        assert perm.is_cuda
        np.testing.assert_array_equal(perm.cpu().numpy(), np.lexsort(tuple(lanes)), err_msg=str(keys))


@pytest.mark.cuda
def test_a_two_version_index_joins_on_the_card_as_on_the_cpu(cuda_device, tmp_path):
    """An incremental refresh leaves a lineage index over two version
    directories whose buckets are no longer sorted by the key, and a deleted
    source file folded into its entry: the co-bucketed join runs in hash mode
    through K1 and K2 on the card and returns the CPU's rows in the CPU's
    order."""
    import os

    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import io as torch_io
    from hyperspace_tpu_torch.engine.table import Table

    rng = np.random.RandomState(11)
    src, r = str(tmp_path / "l"), str(tmp_path / "r")

    def write(path, cols):
        torch_io.write_parquet(Table.from_pydict(cols, "cpu"), path)

    for i in range(3):
        n = 4000
        write(os.path.join(src, f"part-{i:05d}.parquet"),
              {"k": rng.randint(0, 3000, n).astype(np.int64), "x": rng.rand(n)})
    write(os.path.join(r, "part-00000.parquet"), {"k2": np.arange(3000, dtype=np.int64), "w": rng.rand(3000)})
    sessions = {}
    for dev in ("cpu", "cuda"):
        s = hst.HyperspaceSession(warehouse=str(tmp_path / dev), device=dev)
        s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 8)
        s.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
        hs = hst.Hyperspace(s)
        hs.create_index(s.read.parquet(src), hst.IndexConfig("li", ["k"], ["x"]))
        hs.create_index(s.read.parquet(r), hst.IndexConfig("ri", ["k2"], ["w"]))
        hst.enable_hyperspace(s)
        sessions[dev] = (s, hs)
    write(os.path.join(src, "part-00003.parquet"), {"k": rng.randint(0, 3000, 500).astype(np.int64), "x": rng.rand(500)})
    os.remove(os.path.join(src, "part-00000.parquet"))
    out = {}
    for dev, (s, hs) in sessions.items():
        hs.refresh_index("li", "incremental")
        q = s.read.parquet(src).join(s.read.parquet(r), hst.col("k") == hst.col("k2")).select("k", "x", "w")
        assert "BucketedIndexScan" in q.explain_string()
        k1, k2 = cuda_sort.launches, cuda_probe.launches
        out[dev] = q.collect()
        if dev == "cuda":
            assert cuda_sort.launches > k1 and cuda_probe.launches > k2
    assert out["cuda"].num_rows == out["cpu"].num_rows == 8500
    for n in ("k", "x", "w"):
        assert torch.equal(out["cuda"].column(n).data, out["cpu"].column(n).data), n


def _outer_sources(tmp_path):
    """Two sources with nullable int keys and a nullable string payload on
    each side, written once for both devices."""
    import os

    from hyperspace_tpu_torch.engine import io as torch_io
    from hyperspace_tpu_torch.engine.table import Table

    rng = np.random.RandomState(12)
    words = np.array(["ant", "bee", "cat", "dog", "eel"])
    k = rng.randint(0, 400, 6000).astype(object)
    k[::7] = None
    s = words[rng.randint(0, 5, 6000)].astype(object)
    s[::11] = None
    k2 = rng.randint(100, 600, 900).astype(object)
    k2[::13] = None
    paths = {"l": str(tmp_path / "l"), "r": str(tmp_path / "r")}
    torch_io.write_parquet(Table.from_pydict({"k": k, "s": s, "x": rng.rand(6000)}, "cpu"),
                           os.path.join(paths["l"], "part-00000.parquet"))
    torch_io.write_parquet(Table.from_pydict({"k2": k2, "t": words[rng.randint(0, 3, 900)], "w": rng.rand(900)}, "cpu"),
                           os.path.join(paths["r"], "part-00000.parquet"))
    return paths


def _same_table(a, b):
    assert a.column_names == b.column_names and a.num_rows == b.num_rows
    for n in a.column_names:
        ca, cb = a.column(n), b.column(n)
        assert torch.equal(ca.data.cpu(), cb.data.cpu()), n
        assert (ca.validity is None) == (cb.validity is None), n
        if ca.validity is not None:
            assert torch.equal(ca.validity.cpu(), cb.validity.cpu()), n
        if ca.is_string:
            np.testing.assert_array_equal(ca.dictionary, cb.dictionary)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "left_semi", "left_anti"])
def test_every_join_type_on_the_card_equals_the_cpu(cuda_device, tmp_path, how):
    """The outer assembly (masks, `nonzero`, `unique`, the null-filled side,
    the concatenation) and every type's count(), on the card, give the CPU's
    rows in the CPU's order, through the bucketed join (hash mode: K1, K2)
    and the general join."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine.physical import ExecContext

    paths = _outer_sources(tmp_path)
    out = {}
    for dev in ("cpu", "cuda"):
        s = hst.HyperspaceSession(warehouse=str(tmp_path / dev), device=dev)
        s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 8)
        hs = hst.Hyperspace(s)
        hs.create_index(s.read.parquet(paths["l"]), hst.IndexConfig("oL", ["k"], ["s", "x"]))
        hs.create_index(s.read.parquet(paths["r"]), hst.IndexConfig("oR", ["k2"], ["t", "w"]))
        for indexed in (True, False):
            (hst.enable_hyperspace if indexed else hst.disable_hyperspace)(s)
            q = s.read.parquet(paths["l"]).join(s.read.parquet(paths["r"]), hst.col("k") == hst.col("k2"), how)
            assert ("bucketed, no exchange" in q.explain_string()) == indexed
            k1, k2 = cuda_sort.launches, cuda_probe.launches
            got = q.collect()
            if dev == "cuda":
                assert q.physical_plan().execute(ExecContext(s)).column("k").data.is_cuda
                if indexed:
                    assert cuda_sort.launches > k1 and cuda_probe.launches > k2
            out[dev, indexed] = (got, q.count())
    for indexed in (True, False):
        _same_table(out["cuda", indexed][0], out["cpu", indexed][0])
        assert out["cuda", indexed][1] == out["cpu", indexed][1] == out["cpu", indexed][0].num_rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int32_int64", "float_nan", "int64_extremes", "two_keys", "nullable"])
@pytest.mark.parametrize("how", ["inner", "left", "full", "left_anti"])
def test_the_general_count_on_the_card_equals_the_cpu(cuda_device, case, how):
    """`_general_count_fast` on the card: the value-direct branch (an inner
    join on one null-free numeric key pair: numpy's promotion, NaN matching
    nothing, int64 extremes) and the key64 merge with the scatter-max match
    stats, each equal to the CPU's count and to the collected rows."""
    from hyperspace_tpu_torch.engine.physical import (
        ExecContext,
        ShuffleExchangeExec,
        SortExec,
        SortMergeJoinExec,
    )
    from hyperspace_tpu_torch.engine.table import Column, Table

    rng = np.random.RandomState(21)
    n, m = 200_000, 30_000
    pool = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf])
    ext = np.array([-(2**63), -(2**63) + 1, -1, 0, 2**63 - 1], np.int64)
    lk, rk = {
        "int32_int64": ([rng.randint(0, 5000, n).astype(np.int32)], [rng.randint(0, 6000, m).astype(np.int64)]),
        "float_nan": ([np.where(rng.rand(n) < 0.2, pool[rng.randint(0, 5, n)], rng.randint(0, 5000, n))],
                      [np.where(rng.rand(m) < 0.2, pool[rng.randint(0, 5, m)], rng.randint(0, 6000, m))]),
        "int64_extremes": ([ext[rng.randint(0, 5, n)]], [ext[rng.randint(0, 5, 50)]]),
        "two_keys": ([rng.randint(0, 500, n), rng.randint(0, 4, n)], [rng.randint(0, 600, m), rng.randint(0, 4, m)]),
        "nullable": ([rng.randint(0, 5000, n)], [rng.randint(0, 6000, m)]),
    }[case]

    class _Rows:
        """A planned side over a ready table."""

        def __init__(self, table):
            self.table = table

        def execute(self, ctx):
            return self.table

    counts = {}
    for dev in ("cpu", "cuda"):
        def side(keys, prefix):
            cols = {f"{prefix}{i}": Column.from_values(np.asarray(v), dev) for i, v in enumerate(keys)}
            if case == "nullable":
                c = cols[f"{prefix}0"]
                valid = torch.from_numpy(np.random.RandomState(len(keys[0])).rand(len(keys[0])) >= 0.05).to(dev)
                cols[f"{prefix}0"] = Column(c.dtype, c.data, None, valid)
            return Table(cols)

        lt, rt = side(lk, "a"), side(rk, "b")
        lkeys, rkeys = list(lt.column_names), list(rt.column_names)
        join = SortMergeJoinExec(SortExec(lkeys, ShuffleExchangeExec(lkeys, _Rows(lt))),
                                 SortExec(rkeys, ShuffleExchangeExec(rkeys, _Rows(rt))), lkeys, rkeys, how=how)
        ctx = ExecContext(None)
        counts[dev] = (join._general_count_fast(ctx), join.execute(ctx).num_rows)
    assert counts["cuda"] == counts["cpu"] and counts["cpu"][0] == counts["cpu"][1]


@pytest.mark.cuda
def test_hybrid_scan_and_compaction_on_the_card_equal_the_cpu(cuda_device, tmp_path):
    """A float key with NaN and signed zeros, lineage on: a file appended with
    no refresh is merged into the index's buckets (Hybrid Scan, hash mode: K1
    and K2 on the card), then two incremental refreshes (an append, a delete)
    and `optimize_index`. The card's rows, in order, and its compacted files
    (sha256) equal the CPU's."""
    import hashlib
    import os

    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import io as torch_io
    from hyperspace_tpu_torch.engine.table import Table

    rng = np.random.RandomState(5)
    src, r = str(tmp_path / "l"), str(tmp_path / "r")
    pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 3.0, np.inf] + list(np.arange(40.0)))

    def write(path, n):
        torch_io.write_parquet(Table.from_pydict({"k": pool[rng.randint(0, len(pool), n)], "x": rng.rand(n)}, "cpu"),
                               path)

    for i in range(3):
        write(os.path.join(src, f"part-{i:05d}.parquet"), 3000)
    torch_io.write_parquet(Table.from_pydict({"k2": pool.copy(), "w": rng.rand(len(pool))}, "cpu"),
                           os.path.join(r, "part-00000.parquet"))
    sessions = {}
    for dev in ("cpu", "cuda"):
        s = hst.HyperspaceSession(warehouse=str(tmp_path / dev), device=dev)
        s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 8)
        s.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
        s.conf.set(hst.IndexConstants.INDEX_HYBRID_SCAN_ENABLED, "true")
        hs = hst.Hyperspace(s)
        hs.create_index(s.read.parquet(src), hst.IndexConfig("li", ["k"], ["x"]))
        hs.create_index(s.read.parquet(r), hst.IndexConfig("ri", ["k2"], ["w"]))
        hst.enable_hyperspace(s)
        sessions[dev] = (s, hs)
    write(os.path.join(src, "part-00003.parquet"), 700)
    out, shas = {}, {}
    for dev, (s, hs) in sessions.items():
        q = s.read.parquet(src).join(s.read.parquet(r), hst.col("k") == hst.col("k2")).select("k", "x", "w")
        assert "(+1 appended)" in q.explain_string()
        k1, k2 = cuda_sort.launches, cuda_probe.launches
        out[dev] = q.collect()
        assert q.count() == out[dev].num_rows
        if dev == "cuda":
            assert cuda_sort.launches > k1 and cuda_probe.launches > k2
    for n in ("k", "x", "w"):
        assert torch.equal(out["cuda"].column(n).data.cpu(), out["cpu"].column(n).data), n
    write(os.path.join(src, "part-00004.parquet"), 500)
    os.remove(os.path.join(src, "part-00001.parquet"))
    for dev, (s, hs) in sessions.items():
        hs.refresh_index("li", "incremental")
        hs.optimize_index("li")
        e = next(e for e in hs._manager.get_indexes() if e.name == "li")
        assert not e.deleted_source_files()
        shas[dev] = {os.path.basename(p): hashlib.sha256(open(p, "rb").read()).hexdigest() for p in e.content.files()}
    assert shas["cuda"] == shas["cpu"] and len(shas["cpu"]) == 8


@pytest.mark.cuda
def test_data_skipping_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """Sketches of a delta table's files built on the card (torch min / max
    and the bloom scatter there) equal the CPU's file byte for byte, and the
    pruned queries keep the same files and give the same rows."""
    import hashlib
    import os

    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.index.dataskipping import BloomFilterSketch, DataSkippingIndexConfig, MinMaxSketch

    rng = np.random.RandomState(11)
    table = str(tmp_path / "t")
    writer = hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    for i in range(4):
        k = np.sort(rng.randint(i * 1000, i * 1000 + 1000, 5000)).astype(np.int64)
        x = rng.rand(5000)
        x[rng.randint(0, 5000, 20)] = np.nan
        writer.write_delta({"k": k, "x": x, "t": rng.randint(0, 10**9, 5000).astype(np.int64),
                            "s": np.array([f"w{v}" for v in rng.randint(0, 300, 5000)])}, table)
    config = [MinMaxSketch("k", "rowgroup"), MinMaxSketch("x"), BloomFilterSketch("t", 65536, 5),
              BloomFilterSketch("s", 2048, 3)]
    t_probe = int(writer.read.delta(table).collect().column("t").data[7000])
    queries = [
        lambda d: d.filter(hst.col("k") == 2500).select("k", "t"),
        lambda d: d.filter((hst.col("k") >= 1200) & (hst.col("x") < 0.5)).select("k"),
        lambda d: d.filter(hst.col("t") == t_probe).select("k", "t"),
        lambda d: d.filter(hst.col("s").isin("w7", "nope")).select("s"),
    ]
    shas, rows = {}, {}
    for dev in ("cpu", "cuda"):
        s = hst.HyperspaceSession(warehouse=str(tmp_path / dev), device=dev)
        hs = hst.Hyperspace(s)
        hs.create_index(s.read.delta(table), DataSkippingIndexConfig("sk", config))
        hst.enable_hyperspace(s)
        (path,) = next(e for e in hs._manager.get_indexes() if e.name == "sk").content.files()
        shas[dev] = hashlib.sha256(open(path, "rb").read()).hexdigest()
        rows[dev] = []
        for q in queries:
            df = q(s.read.delta(table))
            scan = next(n for n in df.optimized_plan().collect_nodes() if type(n).__name__ == "ScanNode")
            out = df.collect()
            rows[dev].append(([os.path.basename(f.path) for f in scan.relation.files],
                              {n: out.column(n).decode().tolist() for n in out.column_names}, df.count()))
    assert shas["cuda"] == shas["cpu"]
    assert rows["cuda"] == rows["cpu"]
    assert len(rows["cpu"][0][0]) == 1 and len(rows["cpu"][2][0]) < 4


@pytest.mark.cuda
def test_a_partitioned_lineage_build_and_query_on_the_card_equal_the_cpu(cuda_device, tmp_path):
    """A Hive-partitioned source (an int partition with a null, a string
    partition, several files a partition): the lineage index built on the
    card (the partition columns' constants made there) equals the CPU's
    byte for byte, and filters and a co-bucketed join on the nullable
    partition column (a null day matches nothing) give the CPU's rows."""
    import hashlib
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    import hyperspace_tpu_torch as hst

    rng = np.random.RandomState(17)
    src, dim = str(tmp_path / "events"), str(tmp_path / "days")
    for day in ("20", "21", "22", "__HIVE_DEFAULT_PARTITION__"):
        for region in ("north", "south"):
            for j in range(2):
                n = int(rng.randint(200, 900))
                path = os.path.join(src, f"day={day}", f"region={region}", f"part-{j:05d}.parquet")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                pq.write_table(pa.table({"k": rng.randint(0, 300, n).astype(np.int64), "x": rng.rand(n)}), path)
    os.makedirs(dim)
    pq.write_table(pa.table({"day_id": np.array([20, 21, 22, 23], np.int64), "label": ["a", "b", "c", "d"]}),
                   os.path.join(dim, "part-00000.parquet"))
    out, shas = {}, {}
    for dev in ("cpu", "cuda"):
        s = hst.HyperspaceSession(warehouse=str(tmp_path / dev), device=dev)
        s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 8)
        s.conf.set(hst.IndexConstants.INDEX_LINEAGE_ENABLED, "true")
        hs = hst.Hyperspace(s)
        hs.create_index(s.read.parquet(src), hst.IndexConfig("ev", ["k"], ["x"]))
        hs.create_index(s.read.parquet(src), hst.IndexConfig("ev2", ["k"], ["x", "day"]))
        hs.create_index(s.read.parquet(src), hst.IndexConfig("evDay", ["day"], ["k"]))
        hs.create_index(s.read.parquet(dim), hst.IndexConfig("dimIdx", ["day_id"], ["label"]))
        hst.enable_hyperspace(s)
        shas[dev] = {
            e.name: {p.split(str(tmp_path / dev))[-1]: hashlib.sha256(open(p, "rb").read()).hexdigest()
                     for p in e.content.files()}
            for e in hs._manager.get_indexes()
        }
        ev = s.read.parquet(src)
        queries = [
            ev.filter(hst.col("region") == "south").select("k", "x", "day", "region"),
            ev.filter(hst.col("day").is_null()).select("k", "region"),
            ev.filter(hst.col("k") == 7).select("k", "x"),
            ev.join(s.read.parquet(dim), hst.col("day") == hst.col("day_id")).select("k", "label"),
        ]
        assert "BucketedIndexScan index=evDay" in queries[3].explain_string()
        out[dev] = [(q.count(), {n: c.decode_objects().tolist() for n, c in q.collect().columns.items()})
                    for q in queries]
    assert shas["cuda"] == shas["cpu"] and len(shas["cpu"]) == 4
    assert out["cuda"] == out["cpu"]
    assert out["cpu"][1][0] > 0 and None not in out["cpu"][3][1]["k"]


def last_initial(name):
    return None if name is None else name[:1]


@pytest.mark.cuda
def test_set_operations_on_the_card_equal_the_cpu(cuda_device, tmp_path):
    """Q38 and Q87 over co-bucketed joins at a small size, the NaN / ±0.0 /
    null set operations and a UDF, on the card and on the CPU: identical
    rows in identical order (the set operation's row ids, first occurrences
    and membership computed on the card)."""
    import os

    import chip_smoke
    import hyperspace_tpu_torch as hst

    rng = np.random.RandomState(5)
    tables = chip_smoke.setops_tables(rng, 4000, 2000, 1000, 300, 40, 60, chip_smoke.days("1999-12-01"),
                                      chip_smoke.days("2000-02-29"), plant_share=0.2)
    nan = float("nan")
    tables["a"] = {"x": np.array([1.0, nan, -0.0, 0.0, nan, 2.0, None], dtype=object)}
    tables["b"] = {"x": np.array([nan, 0.0, 2.0, None], dtype=object)}
    writer = hst.HyperspaceSession(warehouse=str(tmp_path), device="cpu")
    for t, cols in tables.items():
        writer.write_parquet(cols, str(tmp_path / t))
    rows = {}
    for dev in ("cpu", "cuda"):
        s = hst.HyperspaceSession(warehouse=str(tmp_path / dev), device=dev)
        s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 8)
        hs = hst.Hyperspace(s)

        def read(t, s=s):
            return s.read.parquet(os.path.join(str(tmp_path), t))

        for table, name, indexed, included in chip_smoke.SETOPS_INDEXES:
            hs.create_index(read(table), hst.IndexConfig(name, indexed, included))
        hst.enable_hyperspace(s)
        q38, q87 = chip_smoke.q38_query(read, hst.col), chip_smoke.q87_query(read, hst.col)
        a, b = read("a"), read("b")
        initials = q38.with_column("initial", hst.udf(last_initial, "string")(hst.col("c_last_name")))
        frames = [q38, q87, a.intersect(b), a.subtract(b), a.distinct(), a.union(b),
                  initials.group_by("initial").agg(n=("*", "count"))]
        rows[dev] = [[repr(r) for r in f.collect().rows()] for f in frames] + [[q38.count(), q87.count()]]
        assert sorted(set(chip_smoke.scanned_indexes(q38))) == sorted(n for _, n, _, _ in chip_smoke.SETOPS_INDEXES)
    assert rows["cuda"] == rows["cpu"]
    assert rows["cpu"][2] == [repr((-0.0,)), repr((2.0,)), repr((None,))]
    assert len(rows["cpu"][0]) >= 5 and len(rows["cpu"][1]) >= 5


@pytest.mark.cuda
def test_the_star_stream_and_the_streamed_scan_on_the_card_equal_the_cpu(cuda_device, tmp_path):
    """Phase star's Q3, Q55 and float Q55 as star streams (K1 and K2 in each
    dimension's hash-mode layout) and the streamed store aggregate over six
    files, on the card and on the CPU: identical integer results and group
    order, float sums at rtol 1e-9 (the card's segment sums add in another
    order than the CPU's), each equal to numpy."""
    import os

    import chip_smoke
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.telemetry.profiling import last_join_stages, last_query_stages

    for flag in ("HYPERSPACE_MULTIWAY", "HYPERSPACE_QUERY_STREAMING", "HYPERSPACE_JOIN_CHUNK_ROWS"):
        os.environ.pop(flag, None)
    tables = chip_smoke.star_tables(np.random.RandomState(19), 80_000)
    writer = hst.HyperspaceSession(warehouse=str(tmp_path / "writer"), device="cpu")
    chip_smoke.write_star_tables(writer, tables, str(tmp_path), 6)
    out = {}
    for dev in ("cpu", "cuda"):
        s = hst.HyperspaceSession(warehouse=str(tmp_path / dev), device=dev)
        s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 16)
        hs = hst.Hyperspace(s)

        def read(t, s=s):
            return s.read.parquet(os.path.join(str(tmp_path), t))

        for table, name, indexed, included in chip_smoke.STAR_INDEXES:
            hs.create_index(read(table), hst.IndexConfig(name, indexed, included))
        hst.enable_hyperspace(s)
        launches = cuda_sort.launches, cuda_probe.launches
        results = []
        for step, (make, measure) in chip_smoke.STAR_QUERIES.items():
            before = last_join_stages()
            got = make(read, hst.col, measure).collect().to_numpy()
            stats = last_join_stages()
            assert stats != before and stats["join_mode"] == "star"
            chip_smoke.check_star_rows(f"{step} {dev}", got, chip_smoke.expected_star(tables, step))
            results.append(got)
        before = last_query_stages()
        got = chip_smoke.star_store_query(read).collect().to_numpy()
        assert last_query_stages() != before and last_query_stages()["chunks"] == 6
        chip_smoke.check_store_agg(f"d {dev}", got, chip_smoke.expected_store_agg(tables["store_sales"]))
        results.append(got)
        if dev == "cuda":
            assert cuda_sort.launches > launches[0] and cuda_probe.launches > launches[1]
        out[dev] = results
    for cpu, card in zip(out["cpu"], out["cuda"]):
        assert list(cpu) == list(card)
        for name in cpu:
            a, b = np.asarray(cpu[name]), np.asarray(card[name])
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=1e-9, atol=0)
            else:
                assert a.tolist() == b.tolist(), name


def _faults_lake(tmp_path, n_files=4, rows=2000):
    """A plain source of `n_files` files, keys 0.. in file order, `v` = k % 7."""
    import os

    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.engine.table import Table

    src = os.path.join(str(tmp_path), "src")
    for i in range(n_files):
        k = np.arange(i * rows, (i + 1) * rows, dtype=np.int64)
        engine_io.write_parquet(Table.from_pydict({"k": k, "v": k % 7}, "cpu"), os.path.join(src, f"part-{i:05d}.parquet"))
    return src


@pytest.mark.cuda
def test_a_cuda_session_decides_hash_quantize_on(cuda_device, tmp_path):
    """On a CUDA session the planner's hash-quantize arm is "on" (on the CPU
    "off"), and after the scans' copies the calibration is the measured
    host-to-device rate."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import io as engine_io
    from hyperspace_tpu_torch.plananalysis import planner

    src = _faults_lake(tmp_path)
    engine_io.reset_io_stats()
    arms = {}
    for dev in ("cpu", "cuda"):
        s = hst.HyperspaceSession(warehouse=str(tmp_path / dev), device=dev)
        s.read.parquet(src).group_by("v").agg(t=("k", "sum")).collect()
        arms[dev] = planner.last_decisions()
    assert arms["cuda"].to_ledger()["hash_quantize"]["arm"] == "on"
    assert arms["cpu"].to_ledger()["hash_quantize"]["arm"] == "off"
    assert engine_io.h2d_stats()["bytes"] > 0
    s = hst.HyperspaceSession(warehouse=str(tmp_path / "again"), device="cuda")
    s.read.parquet(src).group_by("v").agg(t=("k", "sum")).collect()
    assert planner.last_decisions().calibration_source == "measured"


@pytest.mark.cuda
def test_corruption_falls_back_with_device_tensors(cuda_device, tmp_path):
    """A corrupt bucket file of an index on a CUDA session: the query warns,
    quarantines the index and answers from the source on the card, equal to
    the CPU's answer; the fallback never reads the index's files again."""
    import os
    import warnings

    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import physical, scan_cache
    from hyperspace_tpu_torch.index import quarantine

    src = _faults_lake(tmp_path, n_files=2)
    rows = {}
    try:
        for dev in ("cpu", "cuda"):
            quarantine.clear()
            s = hst.HyperspaceSession(warehouse=str(tmp_path / dev), device=dev)
            s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 3)
            hs = hst.Hyperspace(s)
            hs.create_index(s.read.parquet(src), hst.IndexConfig("fidx", ["k"], ["v"]))
            hst.enable_hyperspace(s)
            q = s.read.parquet(src).filter(hst.col("k") > 42).select("k", "v")
            clean = q.collect().sorted_rows()
            vdir = os.path.join(str(tmp_path / dev), "indexes", "fidx", "v__=0")
            with open(os.path.join(vdir, sorted(os.listdir(vdir))[0]), "wb") as f:
                f.write(b"not a parquet file")
            scan_cache.clear_scan_caches()
            physical.clear_device_memos()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = q.collect()
                n = q.count()
            assert sum("quarantined" in str(w.message) for w in caught) == 1
            assert quarantine.is_quarantined("fidx") and n == got.num_rows
            rows[dev] = got.sorted_rows()
            assert rows[dev] == clean
    finally:
        quarantine.clear()
    assert rows["cuda"] == rows["cpu"] and len(rows["cpu"]) == 4000 - 43


@pytest.mark.cuda
def test_a_timed_out_query_leaves_no_device_cache_entry(cuda_device, tmp_path, monkeypatch):
    """A query past `HYPERSPACE_QUERY_TIMEOUT_S` under a decode hang raises
    `QueryTimeoutError` on a CUDA session and leaves no decoded column, no
    table and no memo entry on the card; without the deadline it answers."""
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import physical, scan_cache
    from hyperspace_tpu_torch.exceptions import QueryTimeoutError
    from hyperspace_tpu_torch.telemetry import faults

    src = _faults_lake(tmp_path)
    s = hst.HyperspaceSession(warehouse=str(tmp_path / "w"), device="cuda")
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()

    def entries():
        st = scan_cache.stats()
        return (st["scan"]["columns"], st["concat"]["entries"], st["bucketed_concat"]["entries"],
                physical.device_cache_stats()["entries"])

    assert entries() == (0, 0, 0, 0)
    monkeypatch.setenv("HYPERSPACE_QUERY_TIMEOUT_S", "0.1")
    with faults.inject("io.decode", rate=1.0, kind="hang0.3"):
        with pytest.raises(QueryTimeoutError):
            s.read.parquet(src).collect()
    torch.cuda.synchronize()
    assert entries() == (0, 0, 0, 0)
    monkeypatch.delenv("HYPERSPACE_QUERY_TIMEOUT_S")
    out = s.read.parquet(src).collect()
    got = out.to_numpy()
    assert np.array_equal(got["k"], np.arange(8000)) and np.array_equal(got["v"], np.arange(8000) % 7)
    assert entries()[0] > 0  # the decoded columns, cached on the card


@pytest.mark.cuda
def test_launch_labels_count_each_kernel_launch_in_the_registry(cuda_device):
    """Each wrapper's launch adds one to its label's registry counter and to
    its span; its module's `launches` reads that counter."""
    from hyperspace_tpu_torch.telemetry import compile_log, metrics, tracing

    compile_log.reset_launches()
    keys = torch.from_numpy(_sort_input(3, 4, 64)).to(cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in _probe_input(4, 4, 64, 128, 20, np.int64)]
    with tracing.capture() as cap:
        with tracing.query_span("query:labels"):
            cuda_sort.sort_rows(keys)
            cuda_probe.range_probe(*args)
            cuda_probe.range_probe(*args)
    for mod, n in ((cuda_sort, 1), (cuda_probe, 2)):
        assert mod.launches == n == metrics.counter(f"kernel.launches.{mod.LABEL}").value
        assert compile_log.program_summary()[mod.LABEL]["launches"] == n
        assert cap.trace.root.attrs[f"launches.{mod.LABEL}"] == n
    cuda_sort.sort_rows(keys.cpu())
    assert cuda_sort.launches == 1


@pytest.mark.cuda
def test_cuda_event_probes_bill_device_time_at_the_ledger_close(cuda_device, monkeypatch):
    """Under `HYPERSPACE_DEVICE_TIMING=all` every launch gets a pair of CUDA
    events, read only when the ledger closes: device_time_s > 0 and no larger
    than the wall; off, no event is made."""
    from hyperspace_tpu_torch.telemetry import accounting
    from hyperspace_tpu_torch.telemetry import device_observatory as dv

    keys = torch.from_numpy(_sort_input(5, 64, 4096)).to(cuda_device)
    made = []
    real = dv._make_event
    monkeypatch.setattr(dv, "_make_event", lambda device: made.append(1) or real(device))
    monkeypatch.delenv("HYPERSPACE_DEVICE_TIMING", raising=False)
    cuda_sort.sort_rows(keys)
    assert made == []
    monkeypatch.setenv("HYPERSPACE_DEVICE_TIMING", "all")
    dv.reset()
    with accounting.ledger_scope("qid-card", "query:card") as led:
        for _ in range(3):
            cuda_sort.sort_rows(keys)
        assert len(led.probes) == 3 and len(made) == 6
    d = accounting.ledger_for("qid-card").to_dict()
    assert 0.0 < d["device_time_s"] <= d["wall_s"]
    assert dv.device_summary()[cuda_sort.LABEL]["calls"] == 3


@pytest.mark.cuda
def test_explain_analyze_on_the_card_counts_the_star_launches(cuda_device, tmp_path, monkeypatch):
    """The star's analyzed run on the card: rows equal collect(), the K1 and
    K2 launches in the registry rose, the ledger's device time lies in
    (0, wall] and the device samples its live bytes."""
    import os

    import chip_smoke
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.plananalysis.analyze import explain_analyze
    from hyperspace_tpu_torch.telemetry import accounting, compile_log, tracing

    tables = chip_smoke.star_tables(np.random.RandomState(19), 40_000)
    s = hst.HyperspaceSession(warehouse=str(tmp_path / "wh"), device="cuda")
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 16)
    chip_smoke.write_star_tables(s, tables, str(tmp_path), 4)
    hs = hst.Hyperspace(s)

    def read(t):
        return s.read.parquet(os.path.join(str(tmp_path), t))

    for table, name, indexed, included in chip_smoke.STAR_INDEXES:
        hs.create_index(read(table), hst.IndexConfig(name, indexed, included))
    hst.enable_hyperspace(s)
    q = chip_smoke.star_q55_query(read, hst.col)
    plain = q.collect().to_numpy()
    chip_smoke.clear_caches()
    compile_log.reset_launches()
    monkeypatch.setenv("HYPERSPACE_DEVICE_TIMING", "all")
    text, table = explain_analyze(q)
    got = table.to_numpy()
    assert list(got) == list(plain) and all(np.array_equal(got[c], plain[c]) for c in got)
    assert cuda_sort.launches > 0 and cuda_probe.launches > 0
    assert f"{cuda_sort.LABEL}: {cuda_sort.launches}" in text
    d = accounting.ledger_for(tracing.last_trace().query_id).to_dict()
    assert 0.0 < d["device_time_s"] <= d["wall_s"] and d["device_live_bytes"] > 0


@pytest.mark.cuda
def test_the_exporter_samples_live_bytes_from_an_existing_cuda_context(cuda_device, tmp_path):
    """Once the process holds a CUDA context the exporter's frame carries
    `torch.cuda.memory_allocated`, read on the exporter's own thread."""
    import json

    from hyperspace_tpu_torch.telemetry import accounting, exporter

    held = torch.ones(1 << 20, dtype=torch.int64, device=cuda_device)
    assert torch.cuda.is_initialized()
    # The sampler reads at most once a second and hands out the last reading
    # meanwhile: let this stream's first frame take a fresh one.
    accounting._device_sample[0] = -accounting._DEVICE_SAMPLE_MIN_INTERVAL_S
    path = str(tmp_path / "m.jsonl")
    ex = exporter.MetricsExporter(path, interval_s=0.05).start()
    ex.stop()
    with open(path) as f:
        frames = [json.loads(line) for line in f]
    assert frames[-1]["final"] is True
    assert any(fr.get("device_live_bytes", 0) >= held.numel() * 8 for fr in frames)


@pytest.mark.cuda
def test_a_real_capture_window_names_the_probe_kernel(cuda_device, tmp_path, monkeypatch):
    """A capture's `torch.profiler` window, opened on its daemon thread,
    records CUDA activity of the whole process: K2's `windowed_probe`
    launched on this thread once the window has started is in its Chrome
    trace."""
    import json
    import os

    from hyperspace_tpu_torch.telemetry import device_observatory as dv

    monkeypatch.setenv(dv.ENV_PROFILE_DIR, str(tmp_path / "prof"))
    monkeypatch.setenv(dv.ENV_PROFILE_WINDOW_S, "1.5")
    monkeypatch.setenv(dv.ENV_PROFILE_MIN_INTERVAL_S, "0")
    args = [torch.from_numpy(a).to(cuda_device) for a in _probe_input(6, 64, 1024, 4096, 500, np.int64)]
    cuda_probe.range_probe(*args)  # builds the library outside the window
    torch.cuda.synchronize()
    dv.reset()
    cap = dv.maybe_capture("anomaly", {"test": "card"})
    assert cap is not None and os.path.exists(os.path.join(cap, "capture.json"))
    assert dv._trace_started.wait(timeout=120)  # the first window waits for CUPTI
    for _ in range(20):
        cuda_probe.range_probe(*args)
        torch.cuda.synchronize()
    dv._trace_thread[0].join(timeout=60)
    with open(os.path.join(cap, "trace.json")) as f:
        status = json.load(f)
    assert status["trace"] is True and "CUDA" in status["activities"], status
    with open(os.path.join(cap, status["chrome_trace"])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("windowed_probe" in n for n in names)


@pytest.mark.cuda
def test_history_on_under_timing_lands_device_seconds(cuda_device, tmp_path, monkeypatch):
    """`HYPERSPACE_HISTORY=1` with CUDA-event timing: each closed ledger of a
    co-bucketed join on the card lands with its device seconds, and the
    class baseline folds them; rows equal the CPU's."""
    import os

    import chip_smoke
    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.plananalysis import planner
    from hyperspace_tpu_torch.telemetry import history

    rng = np.random.RandomState(8)
    n = 20_000
    src = {"a": {"k": rng.randint(0, 3000, n).astype(np.int64), "x": rng.rand(n)},
           "b": {"k2": np.arange(3000, dtype=np.int64), "y": rng.rand(3000)}}
    monkeypatch.setenv("HYPERSPACE_HISTORY", "1")
    monkeypatch.setenv("HYPERSPACE_HISTORY_DIR", str(tmp_path / "hist"))
    monkeypatch.setenv("HYPERSPACE_DEVICE_TIMING", "all")
    history.reset_stores()
    planner.reset()
    rows = {}
    for dev in ("cpu", "cuda"):
        s = hst.HyperspaceSession(warehouse=str(tmp_path / f"wh-{dev}"), device=dev)
        s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 8)
        hs = hst.Hyperspace(s)
        for name, cols in src.items():
            path = str(tmp_path / f"{dev}-{name}")
            s.write_parquet(cols, path)
            key = "k" if name == "a" else "k2"
            hs.create_index(s.read.parquet(path), hst.IndexConfig(f"{name}Idx{dev}", [key], list(cols)[1:]))
        hst.enable_hyperspace(s)
        a, b = s.read.parquet(str(tmp_path / f"{dev}-a")), s.read.parquet(str(tmp_path / f"{dev}-b"))
        q = a.join(b, hst.col("k") == hst.col("k2")).select("k", "x", "y")
        for _ in range(3):
            chip_smoke.clear_caches()
            rows[dev] = q.collect().sorted_rows()
    assert rows["cpu"] == rows["cuda"]
    store = history.get_store()
    card = [b for b in store.baselines().values() if b.get("device_time_s", 0) > 0]
    assert card and card[0]["n"] == 3 and card[0]["rows_produced"] == 3 * len(rows["cuda"])
    assert os.listdir(str(tmp_path / "hist" / "planner"))
    history.reset_stores()
    planner.reset()


def _served_join_lake(tmp_path, dev):
    """l (3 files of 2,000 rows) ⋈ r on two key columns over covering
    indexes of 8 buckets: the two-column key joins in hash mode (K1, then
    K2); a lookup on l's index beside it."""
    import os

    import hyperspace_tpu_torch as hst
    from hyperspace_tpu_torch.engine import io as torch_io
    from hyperspace_tpu_torch.engine.table import Table

    rng = np.random.RandomState(12)
    src, r = str(tmp_path / "src" / "l"), str(tmp_path / "src" / "r")
    if not os.path.exists(src):
        for i in range(3):
            torch_io.write_parquet(Table.from_pydict({
                "a": rng.randint(0, 40, 2000).astype(np.int64), "b": rng.randint(0, 5, 2000).astype(np.int64),
                "x": rng.rand(2000)}, "cpu"), os.path.join(src, f"part-{i:05d}.parquet"))
        torch_io.write_parquet(Table.from_pydict({
            "a2": np.repeat(np.arange(40, dtype=np.int64), 5), "b2": np.tile(np.arange(5, dtype=np.int64), 40),
            "w": np.arange(200, dtype=np.int64)}, "cpu"), os.path.join(r, "part-00000.parquet"))
    s = hst.HyperspaceSession(warehouse=str(tmp_path / dev), device=dev)
    s.conf.set(hst.IndexConstants.INDEX_NUM_BUCKETS, 8)
    hs = hst.Hyperspace(s)
    hs.create_index(s.read.parquet(src), hst.IndexConfig("li", ["a", "b"], ["x"]))
    hs.create_index(s.read.parquet(r), hst.IndexConfig("ri", ["a2", "b2"], ["w"]))
    hst.enable_hyperspace(s)
    join = s.read.parquet(src).join(s.read.parquet(r), (hst.col("a") == hst.col("a2")) & (hst.col("b") == hst.col("b2")))
    return hs, {
        "join": join.select("a", "b", "x", "w"),
        "agg": join.group_by("w").agg(n=("*", "count"), t=("x", "sum")),
        "lookup": s.read.parquet(src).filter((hst.col("a") == 7) & (hst.col("b") == 3)).select("a", "b", "x"),
    }


@pytest.mark.cuda
def test_a_four_worker_server_on_the_card_returns_the_serial_rows(cuda_device, tmp_path):
    """Twelve submissions (joins, aggregates, lookups; 3 tenants, both lanes)
    on 4 workers sharing the device's default stream: every served table
    equals the serial one on the card (exactly, floats included), which
    equals the CPU session's (float sums at rtol 1e-9: the card adds in
    another order), and K1 and K2 launched while serving."""
    from hyperspace_tpu_torch.engine import physical, scan_cache
    from hyperspace_tpu_torch.telemetry import compile_log

    _, cpu_q = _served_join_lake(tmp_path, "cpu")
    hs, qs = _served_join_lake(tmp_path, "cuda")
    want = {n: q.collect().to_numpy() for n, q in qs.items()}
    cpu = {n: q.collect().to_numpy() for n, q in cpu_q.items()}
    for n in want:
        for c in want[n]:
            if want[n][c].dtype.kind == "f":
                assert np.allclose(want[n][c], cpu[n][c], rtol=1e-9, atol=0), (n, c)
            else:
                assert np.array_equal(want[n][c], cpu[n][c]), (n, c)
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    compile_log.reset_launches(cuda_sort.LABEL, cuda_probe.LABEL)
    names = ["join", "agg", "lookup"] * 4
    with hs.server(max_concurrent=4) as srv:
        futs = [srv.submit(qs[n].collect, tenant=f"t{i % 3}", lane="interactive" if n == "lookup" else "batch")
                for i, n in enumerate(names)]
        got = [f.result(120).to_numpy() for f in futs]
    for n, out in zip(names, got):
        assert list(out) == list(want[n])
        for c in out:
            assert np.array_equal(out[c], want[n][c]), (n, c)
    assert cuda_sort.launches > 0 and cuda_probe.launches > 0


@pytest.mark.cuda
def test_four_threads_first_use_builds_the_library_and_hashes_a_dictionary_once(cuda_device, tmp_path,
                                                                                monkeypatch):
    """Four threads reach the kernel library (a fresh build directory, so it
    must be built) and the dictionary-hash memo at once: one `nvcc` build,
    one hash of the dictionary, and the same library and hashes for all."""
    import threading

    from hyperspace_tpu_torch.ops import _kernels, hashing

    monkeypatch.setattr(_kernels, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_kernels, "_lib", None)
    builds, hashes = [], []
    real_build, real_hash = _kernels._build, hashing._hash_strings
    monkeypatch.setattr(_kernels, "_build", lambda target: (builds.append(target), real_build(target))[1])
    monkeypatch.setattr(hashing, "_hash_strings", lambda d, seed: (hashes.append(seed), real_hash(d, seed))[1])
    dictionary = np.array([f"name-{i}" for i in range(5000)])
    start = threading.Barrier(4)
    out, errs = [], []

    def first_use():
        try:
            start.wait(30)
            lib = _kernels.library()
            h = hashing.host_hash_dictionary(dictionary, 7, cuda_device)
            out.append((lib, h))
        except BaseException as e:  # pragma: no cover - diagnostic
            errs.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errs and len(out) == 4
    assert len(builds) == 1 and len(hashes) == 1
    assert all(lib is out[0][0] for lib, _ in out) and all(h is out[0][1] for _, h in out)
    assert out[0][1].device.type == "cuda" and torch.equal(out[0][1].cpu(), real_hash(dictionary, 7))


@pytest.mark.cuda
def test_a_served_query_whose_launch_fails_resolves_its_future_with_the_error(cuda_device, tmp_path, monkeypatch):
    """K2's C entry reports a launch error: the served query's future raises
    that error, the plain version never runs (no CPU retry), and the server
    serves the next query once the entry is back."""
    from hyperspace_tpu_torch.engine import physical, scan_cache
    from hyperspace_tpu_torch.ops import _kernels

    hs, qs = _served_join_lake(tmp_path, "cuda")
    lib = _kernels.library()
    real_entry = lib.hs_range_probe_i64
    plain_calls = []
    real_plain = cuda_probe.range_probe_plain
    monkeypatch.setattr(cuda_probe, "range_probe_plain", lambda *a: (plain_calls.append(1), real_plain(*a))[1])
    scan_cache.clear_scan_caches()
    physical.clear_device_memos()
    monkeypatch.setattr(lib, "hs_range_probe_i64", lambda *args: 1)  # cudaErrorInvalidValue
    with hs.server(max_concurrent=2) as srv:
        fut = srv.submit(qs["join"].collect, tenant="a")
        with pytest.raises(RuntimeError, match="hs_range_probe failed to launch"):
            fut.result(120)
        monkeypatch.setattr(lib, "hs_range_probe_i64", real_entry)
        assert srv.run(qs["join"].count, tenant="a") > 0
        assert srv.stats()["in_flight"] == 0
    assert plain_calls == []
