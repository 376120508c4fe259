"""The port's noise generator (ops/cuda_rng.py, the plain version of the
CUDA kernel csrc/rng.cu): Philox4x32-10 with the Random123 constants,
uniform values in [-1, 1) by the JAX kernel's mapping.

The round function is pinned by Random123's known-answer vectors and by an
independent implementation on Python integers; the JAX kernel
(experimental/pallas_rng.py) in interpret mode draws all-zero bits, which
pins the bits-to-float mapping.  Then the range, the counter layout (a draw
does not depend on its shape), determinism per seed, distinct streams and
seeds, and the moments.  Last, the wrapper's copy of the kernel's launch
shape against the constants of csrc/rng.cu.
"""
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from deep_tracking_control_tpu.experimental import pallas_rng
from deep_tracking_control_tpu_torch.ops import cuda_rng

MASK = 0xFFFFFFFF
SRC = (Path(cuda_rng.__file__).resolve().parent.parent / "csrc" / "rng.cu")


def _philox_ints(ctr, key):
    """Philox4x32-10 on Python integers."""
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + cuda_rng.W0) & MASK, (k[1] + cuda_rng.W1) & MASK]
        p0, p1 = cuda_rng.M0 * c[0], cuda_rng.M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & MASK, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & MASK]
    return c


def _words(ctr, key):
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    out = cuda_rng.philox4x32([t(v) for v in ctr], [t(v) for v in key])
    return [int(w) for w in out]


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK,) * 4, (MASK, MASK), (0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420,
                                0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    assert _words(ctr, key) == list(want)


def test_philox_matches_python_integers():
    rng = np.random.default_rng(0)
    for _ in range(20):
        ctr = [int(v) for v in rng.integers(0, 2 ** 32, 4)]
        key = [int(v) for v in rng.integers(0, 2 ** 32, 2)]
        assert _words(ctr, key) == _philox_ints(ctr, key)


def test_bits_mapping_is_the_jax_kernels():
    """JAX's interpret mode draws zero bits: the mapping sends them to -1."""
    u = np.asarray(pallas_rng.uniform_pm1(jax.random.PRNGKey(0), (8, 16),
                                          interpret=True))
    zero = cuda_rng.bits_to_pm1(torch.zeros((8, 16), dtype=torch.int64))
    np.testing.assert_array_equal(zero.numpy(), u)
    top = cuda_rng.bits_to_pm1(torch.tensor([MASK]))
    assert float(top) == 1.0 - 2.0 ** -22


def test_range_dtype_and_grid():
    u = cuda_rng.uniform_pm1(torch.tensor([7, 8]), (128, 693))
    assert u.shape == (128, 693) and u.dtype == torch.float32
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0
    k = (u.double() + 1.0) * 2.0 ** 22          # multiples of 2**-22
    assert torch.equal(k, torch.round(k))


def test_counter_layout_is_flat():
    """Element i is word i % 4 of counter block i // 4, whatever the shape:
    a row of an (N, D) draw is a slice of the flat draw."""
    seed = torch.tensor([2 ** 33 + 5, -3])
    flat = cuda_rng.uniform_pm1(seed, (7 * 693,))
    grid = cuda_rng.uniform_pm1(seed, (7, 693))
    assert torch.equal(grid.reshape(-1), flat)
    block = [int(w) for w in cuda_rng.philox4x32(
        [torch.tensor([173]), torch.tensor([0]), torch.tensor([0]),
         torch.tensor([0])], [seed[0] & MASK, seed[1] & MASK])]
    want = cuda_rng.bits_to_pm1(torch.tensor(block))
    assert torch.equal(flat[4 * 173:4 * 174], want)


def test_determinism_streams_and_seeds():
    a = torch.tensor([11, 12])
    u = cuda_rng.uniform_pm1(a, (64, 53))
    assert torch.equal(u, cuda_rng.uniform_pm1(a.clone(), (64, 53)))
    assert not torch.equal(u, cuda_rng.uniform_pm1(a, (64, 53), stream=1))
    assert not torch.equal(u, cuda_rng.uniform_pm1(torch.tensor([11, 13]),
                                                   (64, 53)))
    assert not torch.equal(u, cuda_rng.uniform_pm1(torch.tensor([12, 12]),
                                                   (64, 53)))


def test_moments():
    g = torch.Generator().manual_seed(0)
    u = cuda_rng.uniform_pm1(cuda_rng.draw_seed(g, "cpu"), (512, 693)).double()
    assert abs(float(u.mean())) < 0.01
    assert abs(float(u.var()) - 1.0 / 3.0) < 0.01
    # neighbouring values (words of one block, and adjacent blocks) do not
    # move together
    flat = u.reshape(-1)
    assert abs(float(torch.corrcoef(torch.stack([flat[:-1], flat[1:]]))[0, 1])) < 0.01


def test_wrapper_checks_and_cpu_counts_no_launch():
    before = cuda_rng.uniform_pm1.launches
    cuda_rng.uniform_pm1(torch.tensor([1, 2]), (4, 4))
    assert cuda_rng.uniform_pm1.launches == before
    with pytest.raises(ValueError):
        cuda_rng.uniform_pm1(torch.tensor([1, 2], dtype=torch.int32), (4, 4))
    with pytest.raises(ValueError):
        cuda_rng.uniform_pm1(torch.tensor([1, 2, 3]), (4, 4))
    with pytest.raises(ValueError):
        cuda_rng.uniform_pm1(torch.tensor([1, 2]), (4, 4), stream=-1)
    seed = cuda_rng.draw_seed(torch.Generator().manual_seed(1), "cpu")
    assert seed.dtype == torch.int64 and seed.shape == (2,)
    assert 0 <= int(seed.min()) and int(seed.max()) < 2 ** 32


def test_launch_shape_is_the_kernel_s():
    """The wrapper's copy of csrc/rng.cu's launch shape (threads a block
    and the grid's cap, compile-time constants) is the kernel's: a thread
    per 4 elements, so the env's reset draw (4096, 20) takes 80 blocks of
    256 threads; a ragged tail takes one more thread; a draw past the cap
    is strided over MAX_BLOCKS blocks."""
    src = SRC.read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    cap = re.search(r"constexpr long long MAX_BLOCKS = (\d+)LL \* (\d+);",
                    src)
    assert threads == cuda_rng.THREADS
    assert int(cap.group(1)) * int(cap.group(2)) == cuda_rng.MAX_BLOCKS
    assert re.search(r"__launch_bounds__\(THREADS\) uniform_kernel", src)
    assert re.search(r"uniform_kernel<<<\(unsigned\)\(blocks < MAX_BLOCKS "
                     r"\? blocks : MAX_BLOCKS\),\s+THREADS,", src)
    assert cuda_rng.launch_shape(4096 * 20) == (80, 256)
    assert cuda_rng.launch_shape(1) == (1, 256)
    assert cuda_rng.launch_shape(4 * 256 + 1) == (2, 256)
    assert cuda_rng.launch_shape(2 ** 31 - 1) == (65535 * 32, 256)
