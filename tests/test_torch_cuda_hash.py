"""Kernel K6 (`ops/cuda_hash.key64`) against the plain chain, on a card.

K6 has no CPU mode: these tests are marked `cuda` and skip where no CUDA
device is visible. Both versions run on the same CUDA tensors, and the keys
must be equal bit for bit. The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_hash.py
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from hyperspace_tpu_torch.ops import cuda_hash
from hyperspace_tpu_torch.ops.hashing import key64, key64_plain

SIZES = [0, 1, 255, 256, 257, 1_000_003]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K6 has no CPU mode")
    return torch.device("cuda")


def _nan_payloads(bits_dtype, float_dtype, words):
    return np.array(words, dtype=bits_dtype).view(float_dtype)


def _values(kind: str, n: int, seed: int) -> np.ndarray:
    """n values of a lane kind, its special values first: the integer ends,
    +-0.0, subnormals, +-inf and NaNs with payloads (both signs, quiet and
    signalling)."""
    rng = np.random.RandomState(seed)
    if kind in ("int8", "int16", "int32", "int64"):
        info = np.iinfo(kind)
        special = np.array([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max], dtype=kind)
        body = rng.randint(info.min, info.max, n, dtype=np.int64).astype(kind)
    elif kind == "uint8":
        special = np.array([0, 1, 127, 128, 255], dtype=np.uint8)
        body = rng.randint(0, 256, n).astype(np.uint8)
    elif kind == "bool":
        special = np.array([False, True])
        body = rng.rand(n) < 0.5
    elif kind == "float32":
        special = np.concatenate([
            np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40, 1.1754942e-38, 3.4e38, 1.5], np.float32),
            _nan_payloads(np.uint32, np.float32, [0x7FC00000, 0xFFC00000, 0x7FC00123, 0x7F800001, 0xFF812345]),
        ])
        body = (rng.randn(n) * 10.0 ** rng.randint(-40, 38, n)).astype(np.float32)
    else:
        special = np.concatenate([
            np.array([0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324, 1e-310, 2.2250738585072014e-308, 2.0**60,
                      2.0**63, -(2.0**63), 1.5]),
            _nan_payloads(np.uint64, np.float64, [0x7FF8000000000000, 0xFFF8000000000000, 0x7FF8000000000123,
                                                  0x7FF0000000000001, 0xFFF0123456789ABC]),
        ])
        body = rng.randn(n) * 10.0 ** rng.randint(-300, 300, n)
    out = body.astype(special.dtype)
    k = min(n, len(special))
    out[:k] = special[:k]
    return out


_DICT = np.array(["", "AIR", "MAIL", "REG AIR", "é ü", "x" * 40] + [f"Customer#{i:09d}" for i in range(300)])


def _string_lane(n: int, seed: int, code_dtype, device):
    """A string lane with codes of `code_dtype` (a `Column` takes int32
    codes; the hash reads any integer width, so other widths go in a lane
    that has the column's three attributes)."""
    rng = np.random.RandomState(seed)
    size = min(len(_DICT), 127 if code_dtype == torch.int8 else len(_DICT))
    codes = torch.from_numpy(rng.randint(0, size, n)).to(device=device, dtype=code_dtype)
    return types.SimpleNamespace(data=codes, is_string=True, dictionary=_DICT)


NUMERIC = ["int8", "int16", "int32", "int64", "uint8", "bool", "float32", "float64"]
LANE_KINDS = NUMERIC + ["ff_int32", "ff_int64", "ff_bool", "ff_uint8", "str_int32", "str_int64", "str_int16",
                        "str_int8"]


def _lane(kind: str, n: int, seed: int, device):
    """(lane, force_float) of a lane kind: a numeric tensor, one forced to
    float64 ("ff_"), or a string lane ("str_" and its code width)."""
    if kind.startswith("str_"):
        return _string_lane(n, seed, getattr(torch, kind[4:]), device), False
    forced = kind.startswith("ff_")
    return torch.from_numpy(_values(kind[3:] if forced else kind, n, seed)).to(device), forced


def _check(lanes, force_float=None):
    """K6 equals the plain chain bit for bit, in the launches the plan
    names (none when there are no rows); returns K6's keys."""
    before = cuda_hash.launches
    got = key64(lanes, force_float)
    want = key64_plain(lanes, force_float)
    n = len(want)
    assert got.dtype == torch.int64 and got.is_cuda and got.shape == want.shape
    assert torch.equal(got, want)
    assert cuda_hash.launches == before + (len(cuda_hash.plan(lanes, force_float)) if n else 0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", LANE_KINDS)
def test_k6_equals_the_plain_chain_for_each_lane_kind(cuda_device, kind, n):
    lane, forced = _lane(kind, n, LANE_KINDS.index(kind) + n, cuda_device)
    _check([lane], [forced])
    if n:
        # Second in a tuple, the lane is combined into the first one's hash.
        first = torch.from_numpy(_values("int64", n, 5)).to(cuda_device)
        _check([first, lane], [False, forced])


@pytest.mark.cuda
@pytest.mark.parametrize("n_lanes", range(1, cuda_hash.MAX_LANES + 4))
def test_k6_equals_the_plain_chain_for_1_to_cap_plus_3_lanes(cuda_device, n_lanes):
    """Past MAX_LANES lanes a call resumes from the partial hashes: one
    launch a MAX_LANES lanes."""
    n = 100_003
    kinds = [LANE_KINDS[(3 * i + n_lanes) % len(LANE_KINDS)] for i in range(n_lanes)]
    lanes, forced = zip(*(_lane(k, n, 17 * i + n_lanes, cuda_device) for i, k in enumerate(kinds)))
    before = cuda_hash.launches
    _check(list(lanes), list(forced))
    assert cuda_hash.launches - before == (n_lanes + cuda_hash.MAX_LANES - 1) // cuda_hash.MAX_LANES
    _check(list(lanes))


@pytest.mark.cuda
def test_one_call_of_up_to_the_cap_counts_one_launch(cuda_device):
    from hyperspace_tpu_torch.telemetry import compile_log, metrics

    compile_log.reset_launches(cuda_hash.LABEL)
    n = 4096
    for n_lanes in range(1, cuda_hash.MAX_LANES + 1):
        key64([torch.from_numpy(_values("int32", n, i)).to(cuda_device) for i in range(n_lanes)])
    assert cuda_hash.launches == cuda_hash.MAX_LANES
    assert metrics.counter(f"kernel.launches.{cuda_hash.LABEL}").value == cuda_hash.MAX_LANES
    key64([torch.from_numpy(_values("int32", n, i)).to(cuda_device) for i in range(cuda_hash.MAX_LANES + 1)])
    assert cuda_hash.launches == cuda_hash.MAX_LANES + 2


@pytest.mark.cuda
def test_the_built_kernel_reports_the_wrappers_constants(cuda_device):
    from hyperspace_tpu_torch.ops import _kernels

    want = cuda_hash.abi()
    buf = (ctypes.c_int * (len(want) + 1))()
    assert _kernels.library().hs_key64_abi(buf, len(want) + 1) == len(want)
    assert tuple(buf[:len(want)]) == want


@pytest.mark.cuda
def test_k6_takes_non_contiguous_lanes(cuda_device):
    n = 300_001
    wide = torch.from_numpy(_values("int64", 2 * n, 3)).to(cuda_device)
    pairs = torch.from_numpy(_values("float64", 2 * n, 4)).to(cuda_device).reshape(n, 2)
    strided = [wide[::2], pairs[:, 1], wide[1::2].to(torch.int32)]
    assert not strided[0].is_contiguous() and not strided[1].is_contiguous()
    _check(strided)
    _check(strided, [True, False, True])
    codes = torch.from_numpy(np.random.RandomState(5).randint(0, len(_DICT), 2 * n)).to(cuda_device, torch.int32)
    _check([types.SimpleNamespace(data=codes[::2], is_string=True, dictionary=_DICT), strided[1]])


@pytest.mark.cuda
def test_k6_raises_on_what_it_does_not_take(cuda_device):
    x = torch.arange(10, device=cuda_device)
    before = cuda_hash.launches
    with pytest.raises(ValueError, match="does not take"):
        cuda_hash.key64([x, x.to(torch.float16)])
    with pytest.raises(ValueError, match="equal length"):
        cuda_hash.key64([x, x[:9]])
    with pytest.raises(ValueError, match="1-D"):
        cuda_hash.key64([x.reshape(2, 5)])
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_hash.key64([x, x.cpu()])
    with pytest.raises(ValueError, match="codes"):
        cuda_hash.key64([types.SimpleNamespace(data=x.double(), is_string=True, dictionary=_DICT)])
    with pytest.raises(ValueError, match="at least one"):
        cuda_hash.key64([])
    assert cuda_hash.launches == before


def _q3_keys(n: int, seed: int) -> dict:
    """Q3's group keys (`l_orderkey` int64, `o_orderdate` int32 days,
    `o_shippriority` int32) and the revenue it sums."""
    rng = np.random.RandomState(seed)
    return {
        "l_orderkey": rng.randint(1, 60_000_000, n // 4).repeat(4)[:n].astype(np.int64),
        "o_orderdate": rng.randint(8766, 8826, n // 4 + 1).repeat(4)[:n].astype(np.int32),
        "o_shippriority": np.zeros(n, np.int32),
        "cents": rng.randint(90_000, 10_500_000, n).astype(np.int64),
        "revenue": rng.rand(n) * 1e5,
    }


def _string_nullable_keys(n: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    seg = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"])[rng.randint(0, 5, n)]
    nseg = seg.astype(object)
    nseg[rng.rand(n) < 0.2] = None
    nint = rng.randint(-9, 9, n).astype(object)
    nint[rng.rand(n) < 0.2] = None
    return {"seg": seg, "nseg": nseg, "nint": nint, "cents": rng.randint(-500, 500, n).astype(np.int64),
            "revenue": rng.rand(n) * 1e3}


AGGS = [("total", "sum", "cents"), ("n", "count", None), ("revenue", "sum", "revenue"), ("hi", "max", "revenue")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["q3", "string_nullable"])
def test_hash_aggregate_on_the_card_equals_the_cpu(cuda_device, case):
    """One K6 launch for the group keys; the groups, their order and every
    integer answer equal the CPU's. Float sums agree to 1e-12 relative: the
    card's segment sums add in another order."""
    from hyperspace_tpu_torch.engine.table import Table
    from hyperspace_tpu_torch.ops.aggregate import hash_aggregate

    if case == "q3":
        data, keys = _q3_keys(300_000, 29), ["l_orderkey", "o_orderdate", "o_shippriority"]
    else:
        data, keys = _string_nullable_keys(50_000, 31), ["seg", "nseg", "nint"]
    before = cuda_hash.launches
    got = hash_aggregate(Table.from_pydict(data, cuda_device), keys, AGGS).to_numpy()
    assert cuda_hash.launches == before + 1
    want = hash_aggregate(Table.from_pydict(data, "cpu"), keys, AGGS).to_numpy()
    for name in keys + ["total", "n"]:
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_allclose(got["revenue"].astype(np.float64), want["revenue"].astype(np.float64), rtol=1e-12)
    np.testing.assert_array_equal(got["hi"], want["hi"])
