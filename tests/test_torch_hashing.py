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
