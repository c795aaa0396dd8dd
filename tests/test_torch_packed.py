"""Packed sub-byte code lanes and kernels K3, K4 and K5 of the port against
the JAX package.

On the CPU the port's kernel wrappers take their plain PyTorch versions,
because the tensors lie on the CPU; the JAX package's Pallas kernels run in
interpret mode (`HYPERSPACE_PALLAS_SORT=1` / `HYPERSPACE_PALLAS_PROBE=1`), as
`tests/test_packed_codes.py` runs them. `tests/test_torch_cuda.py` holds the
CUDA kernels against the same plain versions on a card. Inputs are made with
numpy from fixed seeds; outputs are integers: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.engine import packed_codes as jax_pc
from hyperspace_tpu.engine.table import Column as JaxColumn
from hyperspace_tpu.ops import bucket_join as jax_bj
from hyperspace_tpu.ops.hashing import bucket_id as jax_bucket_id
from hyperspace_tpu.ops.pallas_probe import probe_packed_pallas
from hyperspace_tpu.ops.pallas_sort import sort_codes_packed as jax_sort_codes_packed
from hyperspace_tpu.ops.pallas_sort import sort_comp_padded
from hyperspace_tpu.ops.partition import _sort_perm, pallas_packed_build_sort
from hyperspace_tpu_torch.engine import packed_codes as pc
from hyperspace_tpu_torch.engine.table import Column, Table
from hyperspace_tpu_torch.ops import bucket_join as bj
from hyperspace_tpu_torch.ops import cuda_comp_sort, cuda_packed_probe, cuda_packed_sort
from hyperspace_tpu_torch.ops.partition import bucketize_table, packed_build_sort


def _u32(words: torch.Tensor) -> np.ndarray:
    """The port's int32 word tensor as the uint32 words it carries."""
    return words.numpy().view(np.uint32)


def test_width_policy_matches():
    for card in range(0, 40):
        assert pc.bits_for_cardinality(card) == jax_pc.bits_for_cardinality(card)
        assert pc.probe_bits_for_cardinality(card) == jax_pc.probe_bits_for_cardinality(card)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_pack_and_unpack_match(bits):
    rng = np.random.RandomState(bits)
    mat = rng.randint(0, 1 << bits, size=(5, 256))
    got = pc.pack_rows(torch.from_numpy(mat), bits)
    want = np.asarray(jax_pc.pack_rows_traced(jnp.asarray(mat), bits))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(pc.unpack_rows(got, bits).numpy(), np.asarray(jax_pc.unpack_rows_traced(jnp.asarray(want), bits)))
    codes = rng.randint(-1, (1 << bits) - 1, 77)
    words = pc.pack_codes_host(codes, bits)
    np.testing.assert_array_equal(words, jax_pc.pack_codes_host(codes, bits))
    np.testing.assert_array_equal(pc.unpack_codes_host(words, 77, bits), codes)


def _lanes(rng, rows, cap, bits, lens, sort=False):
    top = (1 << bits) - 1
    mat = rng.randint(0, top, size=(rows, cap))
    for b in range(rows):
        if sort:
            mat[b, : lens[b]] = np.sort(mat[b, : lens[b]])
        mat[b, lens[b]:] = top  # pads at the reserved top lane value
    return mat


# K4: every width; a row of one word; empty, all-pad and full rows.
SORT_CASES = [(1, 8, 512), (2, 8, 512), (4, 8, 512), (4, 3, 8), (2, 4, 16), (1, 2, 32)]


@pytest.mark.parametrize("bits,rows,cap", SORT_CASES)
def test_packed_sort_plain_matches_pallas(monkeypatch, bits, rows, cap):
    monkeypatch.setenv("HYPERSPACE_PALLAS_SORT", "1")
    rng = np.random.RandomState(rows * cap + bits)
    lens = rng.randint(0, cap + 1, rows)
    lens[0], lens[-1] = 0, cap
    mat = _lanes(rng, rows, cap, bits, lens)
    words = pc.pack_rows(torch.from_numpy(mat), bits)
    got_codes, got_order = cuda_packed_sort.sort_codes_packed(words, bits)
    want_codes, want_order = jax_sort_codes_packed(jnp.asarray(_u32(words)), bits)
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(want_order))
    np.testing.assert_array_equal(got_order.numpy(), np.argsort(mat, axis=1, kind="stable"))


# K5: every width, right rows longer and shorter, empty sides, one-word rows.
PROBE_CASES = [(4, 8, 256, 512), (2, 6, 512, 256), (1, 4, 256, 256), (4, 3, 8, 8), (2, 5, 16, 64)]


@pytest.mark.parametrize("bits,rows,cap_l,cap_r", PROBE_CASES)
def test_packed_probe_plain_matches_pallas(monkeypatch, bits, rows, cap_l, cap_r):
    monkeypatch.setenv("HYPERSPACE_PALLAS_PROBE", "1")
    rng = np.random.RandomState(rows + cap_l + cap_r + bits)
    l_len = rng.randint(0, cap_l + 1, rows)
    r_len = rng.randint(0, cap_r + 1, rows)
    l_len[0], r_len[1], l_len[-1] = 0, 0, cap_l
    L = _lanes(rng, rows, cap_l, bits, l_len, sort=True)
    R = _lanes(rng, rows, cap_r, bits, r_len, sort=True)
    lw, rw = pc.pack_rows(torch.from_numpy(L), bits), pc.pack_rows(torch.from_numpy(R), bits)
    lo, cnt = cuda_packed_probe.probe_packed(lw, rw, bits, torch.from_numpy(l_len), torch.from_numpy(r_len))
    jlo, jcnt = probe_packed_pallas(
        jnp.asarray(_u32(lw)), jnp.asarray(_u32(rw)), bits, jnp.asarray(l_len), jnp.asarray(r_len)
    )
    jlo, jcnt = np.asarray(jlo), np.asarray(jcnt)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    for b in range(rows):  # lo is defined on the valid left slots
        np.testing.assert_array_equal(lo.numpy()[b, : l_len[b]], jlo[b, : l_len[b]])


def _bucketed_codes(rng, card, lens):
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return rng.randint(0, card, int(starts[-1])).astype(np.int32), starts


# End to end: card 13 (bits 4) and 2 (bits 2), with empty buckets; tiny
# buckets whose cap is one word.
REP_CASES = [(13, [0, 120, 7, 0, 200, 33, 1, 0]), (2, [5, 0, 64, 63, 1]), (13, [3, 1, 2]), (1, [4, 0, 9])]


@pytest.mark.parametrize("card,lens", REP_CASES)
def test_pad_buckets_by_codes_and_probe_match_the_jax_package(monkeypatch, card, lens):
    monkeypatch.setenv("HYPERSPACE_PALLAS_SORT", "1")
    monkeypatch.setenv("HYPERSPACE_PALLAS_PROBE", "1")
    rng = np.random.RandomState(card + len(lens))
    l_codes, l_starts = _bucketed_codes(rng, card, lens)
    r_codes, r_starts = _bucketed_codes(rng, card, rng.permutation(lens))
    reps = {}
    for side, (codes, starts) in {"l": (l_codes, l_starts), "r": (r_codes, r_starts)}.items():
        got = bj.pad_buckets_by_codes(torch.from_numpy(codes), starts, card)
        want = jax_bj.pad_buckets_by_codes(codes, starts, card)
        assert got.bits == want.bits and got.cap == want.cap
        np.testing.assert_array_equal(_u32(got.words), np.asarray(want.words))
        np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
        sorted_ref, order_ref, _ = bj._pad_and_sort_codes(
            torch.from_numpy(codes), torch.from_numpy(starts), len(starts) - 1, got.cap, got.bits
        )
        np.testing.assert_array_equal(got.order.numpy(), order_ref.numpy())
        reps[side] = (got, want)
    lo, cnt = bj.probe_code_ranges(reps["l"][0], reps["r"][0])
    jlo, jcnt = jax_bj.probe_code_ranges(reps["l"][1], reps["r"][1])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    for b in range(len(lens)):
        ls = np.sort(l_codes[l_starts[b]: l_starts[b + 1]])
        rs = np.sort(r_codes[r_starts[b]: r_starts[b + 1]])
        exp = np.searchsorted(rs, ls, "right") - np.searchsorted(rs, ls, "left")
        np.testing.assert_array_equal(cnt.numpy()[b, : len(ls)], exp)
        np.testing.assert_array_equal(lo.numpy()[b, : len(ls)], np.asarray(jlo)[b, : len(ls)])


def test_rep_requires_the_probe_class_and_no_nulls():
    starts = np.array([0, 4])
    codes = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    assert bj.pad_buckets_by_codes(codes, starts, 15) is None  # 15 + 2 > 16
    assert bj.pad_buckets_by_codes(codes, starts, 13, has_nulls=True) is None
    assert bj.pad_buckets_by_codes(codes, starts, 13) is not None
    assert bj.pad_buckets_by_codes(codes[:0], np.array([0, 0]), 13) is None


# K3's route: cardinalities on each side of the class edges, with nulls.
BUILD_CASES = [(1, 0.0), (3, 0.1), (15, 0.2), (16, 0.1), (5, 0.0)]


@pytest.mark.parametrize("card,null_share", BUILD_CASES)
def test_bucketize_single_string_key_matches_pallas_build_sort(monkeypatch, card, null_share):
    monkeypatch.setenv("HYPERSPACE_PALLAS_SORT", "1")
    rng = np.random.RandomState(card)
    n, nb = 3000, 16
    values = np.array([f"v{i:02d}" for i in range(card)])[rng.randint(0, card, n)].astype(object)
    values[rng.rand(n) < null_share] = None
    tcol = Column.from_values(values, "cpu")
    jcol = JaxColumn.from_values(values)
    table = Table({"s": tcol, "rid": Column.from_values(np.arange(n, dtype=np.int64), "cpu")})
    out, starts = bucketize_table(table, ["s"], nb)
    perm = out.column("rid").data.numpy()
    lane = jnp.asarray(jcol.data)
    b = jax_bucket_id([jcol], [lane], nb)
    operm, osb = _sort_perm(b, (lane,), n)
    np.testing.assert_array_equal(perm, np.asarray(operm))
    np.testing.assert_array_equal(starts, np.searchsorted(np.asarray(osb), np.arange(nb + 1)))
    res = pallas_packed_build_sort(b, lane, len(jcol.dictionary), n, nb)
    ours = packed_build_sort(torch.from_numpy(np.array(b)), tcol.data, len(tcol.dictionary), nb)
    assert (res is None) == (ours is None) == (card > 15)
    if res is not None:
        np.testing.assert_array_equal(ours[0].numpy(), res[0])
        np.testing.assert_array_equal(ours[1].numpy(), res[1])


def test_build_past_the_int32_headroom_takes_the_lexsort(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_PALLAS_SORT", "1")
    rng = np.random.RandomState(3)
    n, nb = 300, 1 << 20  # (nb << 4) << 9 overflows int32
    values = np.array(["a", "b", "c", "d", "e"])[rng.randint(0, 5, n)]
    tcol, jcol = Column.from_values(values, "cpu"), JaxColumn.from_values(values)
    lane = jnp.asarray(jcol.data)
    b = jax_bucket_id([jcol], [lane], nb)
    assert pallas_packed_build_sort(b, lane, 5, n, nb) is None
    assert packed_build_sort(torch.from_numpy(np.array(b)), tcol.data, 5, nb) is None
    launches = cuda_comp_sort.launches
    out, _ = bucketize_table(Table({"s": tcol, "rid": Column.from_values(np.arange(n), "cpu")}), ["s"], nb)
    np.testing.assert_array_equal(out.column("rid").data.numpy(), np.asarray(_sort_perm(b, (lane,), n)[0]))
    assert cuda_comp_sort.launches == launches


def test_comp_sort_plain_sorts_each_row():
    rng = np.random.RandomState(4)
    v = torch.from_numpy(rng.permutation(4096).astype(np.int32).reshape(2, 2048))
    np.testing.assert_array_equal(cuda_comp_sort.sort_comp_rows(v).numpy(), np.sort(v.numpy(), axis=1))


@pytest.mark.parametrize("mode", ["", "1", "0"])
def test_packed_staging_gates_match(monkeypatch, mode):
    """`packable_bits` (the packed tier's gate) and `packed_host_codes` agree
    with the JAX package's for a column that rode the encoded read and one
    that did not, under each `HYPERSPACE_PACKED_CODES` setting."""
    from hyperspace_tpu.engine import encoded_device as jax_ed
    from hyperspace_tpu_torch.engine import encoded_device as ed

    monkeypatch.setenv("HYPERSPACE_PACKED_CODES", mode)
    values = np.array(["AIR", "MAIL", "SHIP", "AIR", "RAIL"])
    for encoded in (False, True):
        tcol, jcol = Column.from_values(values, "cpu"), JaxColumn.from_values(values)
        tcol.encoded_read = encoded
        jcol._encoded_read = encoded
        assert ed.column_qualifies(tcol) == jax_ed.column_qualifies(jcol)
        bits = pc.packable_bits(tcol)
        assert bits == jax_pc.packable_bits(jcol)
        np.testing.assert_array_equal(ed.stage_codes(tcol).numpy(), jcol.data)
        if bits is not None:
            np.testing.assert_array_equal(pc.packed_host_codes(tcol, bits), jax_pc.packed_host_codes(jcol, bits))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_packed_probe_lengths_clamp_to_the_row(monkeypatch, bits):
    """Valid lengths past the row or below 0 clamp to [0, cap], as the JAX
    kernel's lane masks do (the CUDA kernel clamps the same way, so its
    wrapper reads no length back to the host)."""
    monkeypatch.setenv("HYPERSPACE_PALLAS_PROBE", "1")
    rng = np.random.RandomState(40 + bits)
    rows, cap_l, cap_r = 4, 64, 128
    l_len = np.array([cap_l + 9, -3, 17, cap_l])
    r_len = np.array([cap_r + 1, 40, -1, 1000])
    clamped_l, clamped_r = np.clip(l_len, 0, cap_l), np.clip(r_len, 0, cap_r)
    L = _lanes(rng, rows, cap_l, bits, clamped_l, sort=True)
    R = _lanes(rng, rows, cap_r, bits, clamped_r, sort=True)
    lw, rw = pc.pack_rows(torch.from_numpy(L), bits), pc.pack_rows(torch.from_numpy(R), bits)
    lo, cnt = cuda_packed_probe.probe_packed(lw, rw, bits, torch.from_numpy(l_len), torch.from_numpy(r_len))
    want_lo, want_cnt = cuda_packed_probe.probe_packed(
        lw, rw, bits, torch.from_numpy(clamped_l), torch.from_numpy(clamped_r))
    np.testing.assert_array_equal(lo.numpy(), want_lo.numpy())
    np.testing.assert_array_equal(cnt.numpy(), want_cnt.numpy())
    _jlo, jcnt = probe_packed_pallas(
        jnp.asarray(_u32(lw)), jnp.asarray(_u32(rw)), bits, jnp.asarray(l_len), jnp.asarray(r_len)
    )
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def _lane_table_case(rng, rows, cap_l, cap_r, bits, kind):
    """Sorted lane rows for the contract K5's lane table relies on: right rows
    of a single lane value, left lanes the right row never holds, rows holding
    every lane value (the top one too), duplicate-heavy rows of two values.
    Pads at the top lane value; row 0 has an empty right side."""
    top = (1 << bits) - 1
    l_len, r_len = rng.randint(0, cap_l + 1, rows), rng.randint(0, cap_r + 1, rows)
    r_len[0], l_len[-1], r_len[-1] = 0, cap_l, cap_r
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
    return L, R, l_len, r_len


@pytest.mark.parametrize("len_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("kind", ["single", "absent", "every", "dups"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_packed_probe_lane_table_cases_match_pallas(monkeypatch, bits, kind, len_dtype):
    """K5's plain version against the Pallas kernel in interpret mode on the
    rows a per-row lane table must get right, with int64 and int32 lengths."""
    monkeypatch.setenv("HYPERSPACE_PALLAS_PROBE", "1")
    rng = np.random.RandomState(100 + 8 * bits + len(kind))
    rows, cap_l, cap_r = 5, 64, 128
    L, R, l_len, r_len = _lane_table_case(rng, rows, cap_l, cap_r, bits, kind)
    l_len, r_len = l_len.astype(len_dtype), r_len.astype(len_dtype)
    lw, rw = pc.pack_rows(torch.from_numpy(L), bits), pc.pack_rows(torch.from_numpy(R), bits)
    lo, cnt = cuda_packed_probe.probe_packed(lw, rw, bits, torch.from_numpy(l_len), torch.from_numpy(r_len))
    assert lo.dtype == cnt.dtype == torch.int32
    jlo, jcnt = probe_packed_pallas(
        jnp.asarray(_u32(lw)), jnp.asarray(_u32(rw)), bits, jnp.asarray(l_len), jnp.asarray(r_len)
    )
    jlo, jcnt = np.asarray(jlo), np.asarray(jcnt)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    for b in range(rows):  # lo is defined on the valid left slots
        np.testing.assert_array_equal(lo.numpy()[b, : l_len[b]], jlo[b, : l_len[b]])
    # The table's own terms: lo = T[x], counts = T[x + 1] - T[x] over the valid right prefix.
    for b in range(rows):
        table = np.searchsorted(R[b, : r_len[b]], np.arange((1 << bits) + 1), "left")
        x = L[b, : l_len[b]]
        np.testing.assert_array_equal(lo.numpy()[b, : l_len[b]], table[x])
        np.testing.assert_array_equal(cnt.numpy()[b, : l_len[b]], table[x + 1] - table[x])
        assert not lo.numpy()[b, l_len[b]:].any() and not cnt.numpy()[b, l_len[b]:].any()


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _comp_rows(rng, rows, cap, kind):
    if kind == "wide":
        v = rng.randint(_I32_MIN, _I32_MAX + 1, size=(rows, cap), dtype=np.int64)
    elif kind == "dup":
        v = rng.randint(-3, 4, size=(rows, cap))
    elif kind == "extreme":
        v = rng.choice(np.array([_I32_MIN, _I32_MIN + 1, -1, 0, 1, _I32_MAX - 1, _I32_MAX]), size=(rows, cap))
    else:  # one row of pads among rows of negative keys
        v = rng.randint(_I32_MIN, 0, size=(rows, cap), dtype=np.int64)
        v[rows // 2] = _I32_MAX
    return v.astype(np.int32)


# K3: several rows; negative keys, duplicates, the int32 ends, all-pad rows.
COMP_CASES = [(3, 256, "wide"), (8, 128, "dup"), (4, 64, "extreme"), (5, 32, "allpad"), (2, 1024, "wide"),
              (16, 8, "extreme")]


@pytest.mark.parametrize("rows,cap,kind", COMP_CASES)
def test_comp_sort_plain_matches_pallas_on_any_int32(rows, cap, kind):
    """K3's plain version against `sort_comp_padded` in interpret mode: the
    contract is an ascending sort of each row whatever its int32 values, which
    is what the radix kernel is held to on the card."""
    v = _comp_rows(np.random.RandomState(rows * cap), rows, cap, kind)
    got = cuda_comp_sort.sort_comp_rows(torch.from_numpy(v))
    want = np.asarray(sort_comp_padded(jnp.asarray(v), True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.sort(v, axis=1))
