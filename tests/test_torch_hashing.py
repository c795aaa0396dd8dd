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


def _narrow_columns():
    rng = np.random.RandomState(13)
    n = 4096
    return {
        "int8": np.concatenate([[-128, -1, 0, 127], rng.randint(-128, 128, n - 4)]).astype(np.int8),
        "int16": np.concatenate([[-(2**15), -1, 0, 2**15 - 1], rng.randint(-(2**15), 2**15, n - 4)]).astype(np.int16),
        "uint8": np.concatenate([[0, 1, 128, 255], rng.randint(0, 256, n - 4)]).astype(np.uint8),
        "bool": rng.rand(n) < 0.5,
        "int64": rng.randint(-(2**62), 2**62, n, dtype=np.int64),
    }


NARROW_CASES = [["int8"], ["int16"], ["uint8"], ["bool"], ["int8", "uint8", "bool", "int16", "int64"]]


@pytest.mark.parametrize("names", NARROW_CASES, ids=["+".join(c) for c in NARROW_CASES])
def test_key64_bit_identical_for_narrow_integer_and_bool_lanes(names):
    """The plain chain widens int8, int16, uint8 and bool lanes to int64 as
    the JAX package does. The JAX package's columns take no narrow dtype, so
    its column (which only says "numeric") holds the int64 widening and its
    device array the narrow values."""
    cols = _narrow_columns()
    arrays = [cols[n] for n in names]
    kinds = [Column.from_values(a.astype(np.int64)) for a in arrays]
    want = jax_hashing.key64(kinds, [jnp.asarray(a) for a in arrays])
    got = torch_hashing.key64([torch.from_numpy(a) for a in arrays])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_key64_on_the_cpu_never_loads_the_cuda_library(monkeypatch):
    """CPU lanes take the plain chain: the kernel library is never asked for."""
    from hyperspace_tpu_torch.engine.table import Column as TorchColumn
    from hyperspace_tpu_torch.ops import _kernels

    def refuse():
        raise AssertionError("key64 on the CPU loaded the CUDA library")

    monkeypatch.setattr(_kernels, "library", refuse)
    cols, strings = _columns(), _string_columns()
    n = len(strings["name"])
    lanes = [torch.from_numpy(cols["int64"][:n]), torch.from_numpy(cols["float64"][:n]),
             TorchColumn.from_values(strings["name"], "cpu")]
    for force_float in (None, [True, False, False]):
        got = torch_hashing.key64(lanes, force_float)
        assert torch.equal(got, torch_hashing.key64_plain(lanes, force_float))


@pytest.mark.parametrize("n_lanes", [1, 8, 9], ids=["one", "cap", "cap+1"])
def test_the_kernel_plan_gives_kinds_dtype_codes_and_launches(n_lanes):
    """`cuda_hash.plan`: one descriptor per lane, at most MAX_LANES a launch.
    The lanes cycle through an int32 tensor, a float32 tensor, a string
    column, a bool tensor forced to float64 and a uint8 tensor."""
    from hyperspace_tpu_torch.engine.table import Column as TorchColumn
    from hyperspace_tpu_torch.ops import cuda_hash

    assert cuda_hash.MAX_LANES == 8
    n = 5
    menu = [
        (torch.zeros(n, dtype=torch.int32), False, (cuda_hash.KIND_INT, 2)),
        (torch.zeros(n, dtype=torch.float32), False, (cuda_hash.KIND_FLOAT, 6)),
        (TorchColumn.from_values(np.array(["a", "b", "a", "c", "b"]), "cpu"), True, (cuda_hash.KIND_STRING, 2)),
        (torch.zeros(n, dtype=torch.bool), True, (cuda_hash.KIND_FLOAT, 5)),
        (torch.zeros(n, dtype=torch.uint8), False, (cuda_hash.KIND_INT, 4)),
    ]
    picks = [menu[i % len(menu)] for i in range(n_lanes)]
    plan = cuda_hash.plan([p[0] for p in picks], [p[1] for p in picks])
    want = [(i, *picks[i][2]) for i in range(n_lanes)]
    assert plan == [want[lo:lo + 8] for lo in range(0, n_lanes, 8)]
    assert [len(c) for c in plan] == {1: [1], 8: [8], 9: [8, 1]}[n_lanes]
    assert cuda_hash.plan([torch.zeros(n, dtype=torch.int64)]) == [[(0, cuda_hash.KIND_INT, 3)]]
    assert cuda_hash.plan([torch.zeros(n, dtype=torch.float64)], [True]) == [[(0, cuda_hash.KIND_FLOAT, 7)]]


@pytest.mark.parametrize("lanes", [[], [torch.zeros(3, dtype=torch.float16)], [torch.zeros(3, dtype=torch.complex64)]],
                         ids=["none", "float16", "complex64"])
def test_the_kernel_plan_refuses_what_the_kernel_does_not_take(lanes):
    from hyperspace_tpu_torch.ops import cuda_hash

    with pytest.raises(ValueError, match="key64"):
        cuda_hash.plan(lanes)


def _cu_constants():
    """`csrc/key_hash.cu`'s kMaxLanes, Kind and Dtype codes by name, the
    order `hs_key64_abi` lists them in, and HsLane's field types."""
    import os
    import re

    from hyperspace_tpu_torch.ops import _kernels

    with open(os.path.join(_kernels._CSRC, "key_hash.cu")) as fh:
        src = fh.read()
    names = {"kMaxLanes": int(re.search(r"constexpr int kMaxLanes = (\d+);", src).group(1))}
    for enum in ("Kind", "Dtype"):
        body = re.search(r"enum %s : int32_t \{([^}]*)\}" % enum, src).group(1)
        for name, value in re.findall(r"(k\w+) = (\d+)", body):
            names[name] = int(value)
    order = re.search(r"const int values\[\] = \{([^}]*)\}", src).group(1)
    order = [w.strip() for w in order.replace("\n", " ").split(",")]
    fields = re.search(r"struct HsLane \{([^}]*)\}", src).group(1)
    fields = [line.strip().rsplit(" ", 1)[0] for line in fields.strip().splitlines()]
    return names, order, fields


def test_the_kernel_constants_are_the_cuda_sources():
    """The wrapper's lane cap, kind and dtype codes and lane layout are the
    ones `csrc/key_hash.cu` defines, and `abi()` lists them in the order
    `hs_key64_abi` returns them."""
    import ctypes

    from hyperspace_tpu_torch.ops import cuda_hash

    names, order, fields = _cu_constants()
    assert names["kMaxLanes"] == cuda_hash.MAX_LANES
    assert (names["kInt"], names["kFloat"], names["kString"]) == (
        cuda_hash.KIND_INT, cuda_hash.KIND_FLOAT, cuda_hash.KIND_STRING)
    c_dtypes = {"kI8": torch.int8, "kI16": torch.int16, "kI32": torch.int32, "kI64": torch.int64,
                "kU8": torch.uint8, "kBool": torch.bool, "kF32": torch.float32, "kF64": torch.float64}
    assert {cuda_hash.DTYPE_CODES[dt]: dt for dt in cuda_hash.DTYPE_CODES} == {
        names[k]: dt for k, dt in c_dtypes.items()}
    assert order[-1] == "static_cast<int>(sizeof(HsLane))"
    assert tuple(names[w] for w in order[:-1]) == cuda_hash.abi()[:-1]
    pointer, int32 = ("const void*", "const int64_t*"), "int32_t"
    assert [f in pointer if t == ctypes.c_void_p else f == int32
            for f, (_, t) in zip(fields, cuda_hash._Lane._fields_)] == [True] * 5
    assert len(fields) == len(cuda_hash._Lane._fields_)
    assert cuda_hash.abi()[-1] == ctypes.sizeof(cuda_hash._Lane) == 32


@pytest.mark.parametrize("change", [None, "count", "cap", "dtype", "size"])
def test_the_wrapper_refuses_a_kernel_with_other_constants(monkeypatch, change):
    """`cuda_hash._check_abi` passes a library whose `hs_key64_abi` gives
    `abi()`, and raises on a short list, another cap, dtype code or lane
    size, before any launch."""
    from hyperspace_tpu_torch.ops import cuda_hash

    values = list(cuda_hash.abi())
    if change == "cap":
        values[0] += 1
    elif change == "dtype":
        values[4], values[5] = values[5], values[4]
    elif change == "size":
        values[-1] = 40
    elif change == "count":
        values = values[:-1]

    def hs_key64_abi(buf, cap):
        for i, v in enumerate(values[:cap]):
            buf[i] = v
        return len(values)

    monkeypatch.setattr(cuda_hash, "_abi_checked", False)
    lib = type("Lib", (), {"hs_key64_abi": staticmethod(hs_key64_abi)})
    if change is None:
        cuda_hash._check_abi(lib)
        assert cuda_hash._abi_checked
    else:
        with pytest.raises(RuntimeError, match="constants"):
            cuda_hash._check_abi(lib)
        assert not cuda_hash._abi_checked
