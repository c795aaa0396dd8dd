"""The port's CUDA kernels against their plain PyTorch versions, on a card.

K1 (`ops/cuda_sort.sort_rows`) and K2 (`ops/cuda_probe.range_probe`) have no
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


def _sort_input(seed, rows, cap):
    rng = np.random.RandomState(seed)
    keys = rng.randint(-(2**62), 2**62, size=(rows, cap), dtype=np.int64)
    keys[0, : cap // 2] = 5  # a duplicate run: ties resolve by slot
    for b in range(rows):
        keys[b, rng.randint(0, cap + 1):] = PAD
    return keys


def _probe_input(seed, rows, cap_l, cap_r, distinct, dtype):
    rng = np.random.RandomState(seed)
    l_len = rng.randint(0, cap_l + 1, rows)
    r_len = rng.randint(0, cap_r + 1, rows)
    l_len[0], r_len[min(1, rows - 1)] = 0, 0
    pad = np.finfo(np.float64).max if dtype == np.float64 else PAD
    ls = np.full((rows, cap_l), pad, dtype)
    rs = np.full((rows, cap_r), pad, dtype)
    for b in range(rows):
        ls[b, : l_len[b]] = np.sort(rng.randint(0, distinct, l_len[b])).astype(dtype)
        rs[b, : r_len[b]] = np.sort(rng.randint(0, distinct, r_len[b])).astype(dtype)
    return ls, rs, l_len.astype(np.int64), r_len.astype(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cap", [(3, 1), (5, 2), (8, 256), (4, 16384), (3, 32768), (2, 65536)])
def test_sort_kernel_equals_plain(cuda_device, rows, cap):
    keys = torch.from_numpy(_sort_input(rows + cap, rows, cap)).to(cuda_device)
    before = cuda_sort.launches
    got, want = cuda_sort.sort_rows(keys), cuda_sort.sort_rows_plain(keys)
    assert cuda_sort.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "seed,rows,cap_l,cap_r,distinct,dtype",
    [
        (0, 8, 256, 512, 40, np.int64),
        (1, 4, 256, 1024, 2**40, np.int64),
        (2, 8, 256, 512, 30, np.float64),
        (3, 3, 512, 512, 7, np.int64),
        (4, 4, 1024, 32768, 500, np.int64),
    ],
)
def test_probe_kernel_equals_plain(cuda_device, seed, rows, cap_l, cap_r, distinct, dtype):
    args = [torch.from_numpy(a).to(cuda_device) for a in _probe_input(seed, rows, cap_l, cap_r, distinct, dtype)]
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
