"""Uniform noise in [-1, 1) from a counter-based generator: the CUDA kernel
csrc/rng.cu (with the generator in csrc/philox.cuh) and its plain version.

Replaces the JAX package's experimental/pallas_rng.py `uniform_pm1` (the
Pallas kernel `_kernel`), which drew the bits from the TPU core's own
generator.  The card has no such generator, so both versions here run
Philox4x32-10 (Salmon et al., SC'11; the Random123 constants): the key is
the two low words of `seed`, the counter of flat element i is
(i // 4 as two words, `stream`, 0) and the element is word i % 4 of the
output block.  Bits map to floats as in the JAX kernel
(pallas_rng.py:41-46): ((bits >> 9) as int) * 2**-22 - 1, which is exact
in float32, so the kernel and the plain version agree bit for bit.

`seed` is a (2,) int64 tensor on the device of the output, drawn from the
caller's torch.Generator; the kernel reads it through a pointer, so no
value crosses to the host.  `offset` starts the output at flat element
`offset` of that layout: a rank that holds rows [r, r + n) of an (N, D)
draw takes offset r * D and gets those rows of the unsharded draw, bit
for bit, whatever D is (the first counter block may start mid-block).
The kernel is bound by bytes (4 bytes written per element; the 10 rounds
cost 2.5 multiply-high pairs per element).
"""
from __future__ import annotations

import torch


M0, M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
ROUNDS = 10
_MASK = 0xFFFFFFFF
# the kernel's launch shape (csrc/rng.cu constants): a thread per 4
# elements, THREADS threads a block, at most MAX_BLOCKS blocks
THREADS = 256
MAX_BLOCKS = 65535 * 32


def _n_blocks(numel: int, offset: int = 0) -> int:
    """Counter blocks that elements [offset, offset + numel) touch."""
    return (offset + numel + 3) // 4 - offset // 4 if numel else 0


def _mulhilo(m: int, x):
    """(hi, lo) words of the 64-bit product of the constant m and int64
    tensor x < 2**32, from 16-bit halves (an int64 product of two 32-bit
    values overflows)."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    low = ml * xl
    mid = mh * xl + ml * xh                    # < 2**33
    t = low + ((mid & 0xFFFF) << 16)           # < 2**33
    lo = t & _MASK
    hi = (mh * xh + (mid >> 16) + (t >> 32)) & _MASK
    return hi, lo


def philox4x32(ctr, key):
    """Philox4x32-10 on int64 tensors of 32-bit words: ctr a list of 4,
    key a list of 2 (broadcastable).  Returns the 4 output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & _MASK
            k1 = (k1 + W1) & _MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_pm1(bits):
    """32-bit words (int64 tensor) -> float32 uniform in [-1, 1)."""
    return (bits >> 9).to(torch.float32) * (2.0 ** -22) - 1.0


def uniform_pm1_plain(seed, shape, stream: int = 0, offset: int = 0):
    """Plain PyTorch version of the kernel, on the device of `seed`."""
    dev = seed.device
    numel = 1
    for s in shape:
        numel *= s
    first = offset // 4
    c = torch.arange(first, first + _n_blocks(numel, offset),
                     dtype=torch.int64, device=dev)
    zero = torch.zeros_like(c)
    words = philox4x32(
        [c & _MASK, c >> 32, zero + stream, zero],
        [seed[0] & _MASK, seed[1] & _MASK])
    lead = offset - 4 * first
    bits = torch.stack(words, dim=1).reshape(-1)[lead:lead + numel]
    return bits_to_pm1(bits).reshape(shape)


def _check_seed(seed):
    if seed.dtype != torch.int64 or tuple(seed.shape) != (2,):
        raise ValueError(f"seed: {seed.dtype} {tuple(seed.shape)}, expected "
                         "a (2,) int64 tensor")
    if not seed.is_contiguous():
        raise ValueError("seed: not contiguous")


def uniform_pm1(seed, shape, stream: int = 0, offset: int = 0):
    """(N, D) float32 uniform in [-1, 1) from Philox4x32-10 keyed by `seed`
    ((2,) int64) on counter stream `stream`, from flat element `offset`
    of the counter layout on.  A CPU seed takes the plain version; a CUDA
    seed launches the kernel or raises."""
    _check_seed(seed)
    if not 0 <= stream < 2 ** 31:
        raise ValueError(f"stream {stream} is not in [0, 2**31)")
    if offset < 0:
        raise ValueError(f"offset {offset} < 0")
    return uniform_pm1_plain(seed, shape, stream, offset)

def draw_seed(generator, device):
    """A (2,) int64 seed of two 32-bit words from `generator`."""
    return torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                         generator=generator, device=device)


# the launch count: a plain integer on the public wrapper, counted through
# this fixed reference (a caller may wrap the module attribute)
