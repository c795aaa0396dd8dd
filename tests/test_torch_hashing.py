"""The port's bucket hash and join key are bit-identical to the JAX package's.

Co-bucketing an index built by one package with one built by the other rests
on `bucket_id` (build) and `key64` (join) agreeing bit for bit
(`hyperspace_tpu/ops/hashing.py:19-21`). Inputs come from numpy with a fixed
seed and go through both packages; tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.engine.table import Column
from hyperspace_tpu.ops import hashing as jax_hashing
from hyperspace_tpu_torch.ops import hashing as torch_hashing


def _columns():
    rng = np.random.RandomState(7)
    n = 4096
    ints = rng.randint(-(2**62), 2**62, n, dtype=np.int64)
    ints[:6] = [0, -1, 1, 2**63 - 1, -(2**63), 2**32]
    floats = rng.randn(n) * 1e6
    floats[:8] = [0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 1e-310, 2.0**60]
    return {
        "int32": rng.randint(-(2**31), 2**31 - 1, n).astype(np.int32),
        "int64": ints,
        "float64": floats,
        "small": rng.randint(0, 50, n).astype(np.int64),
    }


CASES = [["int32"], ["int64"], ["float64"], ["int64", "small"], ["float64", "int32"], ["small", "int64", "float64"]]


def _jax(names, fn, *args):
    cols = _columns()
    arrays = [cols[n] for n in names]
    return np.asarray(fn([Column.from_values(a) for a in arrays], [jnp.asarray(a) for a in arrays], *args))


def _torch(names, fn, *args):
    cols = _columns()
    return fn([torch.from_numpy(cols[n]) for n in names], *args).numpy()


@pytest.mark.parametrize("names", CASES, ids=["+".join(c) for c in CASES])
def test_key64_bit_identical(names):
    np.testing.assert_array_equal(_torch(names, torch_hashing.key64), _jax(names, jax_hashing.key64))


@pytest.mark.parametrize("num_buckets", [200, 16, 7])
@pytest.mark.parametrize("names", CASES, ids=["+".join(c) for c in CASES])
def test_bucket_id_bit_identical(names, num_buckets):
    got = _torch(names, torch_hashing.bucket_id, num_buckets)
    want = _jax(names, jax_hashing.bucket_id, num_buckets)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_forced_float_lane_matches():
    """The cross-kind hash space (an int key hashed as float64) agrees too."""
    got = _torch(["int32", "small"], torch_hashing.key64, [True, False])
    want = _jax(["int32", "small"], jax_hashing.key64, [True, False])
    np.testing.assert_array_equal(got, want)


def test_signed_zero_and_width_canonicalization():
    """-0.0 hashes as +0.0, and an int32 column hashes as its int64 values."""
    z = torch_hashing.key64([torch.tensor([0.0, -0.0], dtype=torch.float64)])
    assert z[0] == z[1]
    a = torch_hashing.key64([torch.tensor([5, -9], dtype=torch.int32)])
    b = torch_hashing.key64([torch.tensor([5, -9], dtype=torch.int64)])
    assert torch.equal(a, b)


def _string_columns():
    """String, nullable and mixed key columns, made with numpy from a seed."""
    rng = np.random.RandomState(11)
    n = 3000
    seg = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"])[rng.randint(0, 5, n)]
    names = np.array([f"Customer#{i:09d}" for i in rng.randint(0, 150000, n)])
    names[:3] = ["", "é ü", "x" * 40]  # empty, non-ASCII, long
    nseg = seg.astype(object)
    nseg[rng.rand(n) < 0.25] = None
    nint = rng.randint(-9, 9, n).astype(object)
    nint[rng.rand(n) < 0.25] = None
    return {"seg": seg, "name": names, "nseg": nseg, "nint": nint, "k": rng.randint(0, 100, n).astype(np.int64)}


STRING_CASES = [["seg"], ["name"], ["nseg"], ["nint"], ["seg", "k"], ["k", "nseg", "name"], ["nint", "seg"]]


def _both(names, fn_name, *args):
    from hyperspace_tpu_torch.engine.table import Column as TorchColumn

    cols = _string_columns()
    jcols = [Column.from_values(cols[n]) for n in names]
    want = getattr(jax_hashing, fn_name)(jcols, [jnp.asarray(c.data) for c in jcols], *args)
    got = getattr(torch_hashing, fn_name)([TorchColumn.from_values(cols[n], "cpu") for n in names], *args)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("names", STRING_CASES, ids=["+".join(c) for c in STRING_CASES])
def test_key64_bit_identical_for_string_and_nullable_keys(names):
    got, want = _both(names, "key64")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("names", STRING_CASES, ids=["+".join(c) for c in STRING_CASES])
def test_bucket_id_bit_identical_for_string_and_nullable_keys(names):
    got, want = _both(names, "bucket_id", 200)
    np.testing.assert_array_equal(got, want)


def test_dictionary_hash_matches():
    d = np.array(["", "AIR", "MAIL", "REG AIR", "é"])
    for seed in (0x9747B28C, 0x85EBCA6B):
        np.testing.assert_array_equal(
            torch_hashing.host_hash_dictionary(d, seed).numpy(), np.asarray(jax_hashing.host_hash_dictionary(d, seed))[: len(d)]
        )


def test_dictionary_hash_memo_hashes_once_and_stays_bit_identical(monkeypatch):
    """The memo (`hashing.py` :153-200): a second call on the same
    dictionary object and seed hashes nothing and returns the same values;
    another seed or another (equal) dictionary object hashes again; the
    values stay the JAX package's."""
    calls = []
    real = torch_hashing._hash_strings

    def counted(dictionary, seed):
        calls.append((id(dictionary), seed))
        return real(dictionary, seed)

    monkeypatch.setattr(torch_hashing, "_hash_strings", counted)
    d = np.array([f"name-{i:04d}" for i in range(500)] + ["é", ""])
    seed = 0x9747B28C
    first = torch_hashing.host_hash_dictionary(d, seed).clone()
    again = torch_hashing.host_hash_dictionary(d, seed)
    assert len(calls) == 1
    assert torch.equal(first, again)
    np.testing.assert_array_equal(again.numpy(), np.asarray(jax_hashing.host_hash_dictionary(d, seed))[: len(d)])
    torch_hashing.host_hash_dictionary(d, 0x85EBCA6B)
    assert len(calls) == 2
    twin = d.copy()
    assert torch.equal(torch_hashing.host_hash_dictionary(twin, seed), first)
    assert len(calls) == 3
    from hyperspace_tpu_torch.engine.table import Column as TorchColumn

    codes = torch.as_tensor(np.arange(len(d), dtype=np.int32))
    hashed = torch_hashing.column_hash_u32(TorchColumn("string", codes, d), seed)
    assert len(calls) == 3  # the column's dictionary is `d`: served by the memo
    assert torch.equal(hashed, first)


def test_dictionary_hash_memo_dies_with_its_dictionary():
    import gc

    d = np.array(["a", "b", "c"])
    torch_hashing.host_hash_dictionary(d, 7)
    key = (id(d), 7)
    assert key in torch_hashing._dict_hash_cache
    del d
    gc.collect()
    assert key not in torch_hashing._dict_hash_cache
