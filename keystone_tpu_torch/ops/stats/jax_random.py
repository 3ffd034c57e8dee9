"""``jax.random``'s threefry-2x32 draws, reproduced bit for bit in torch.

The JAX package draws its sample scores and synthetic templates with
``jax.random`` (``PRNGKey``, ``fold_in``, ``split``, ``uniform``,
``gumbel``). The port reproduces those draws on the device the caller
names, so it samples the same rows and builds the same templates.

Layout: the partitionable threefry (``jax_threefry_partitionable``,
jax ≥ 0.5's default). A key is a pair of uint32 words ``(k1, k2)``: two
Python ints, or two int64 tensors of one shape (a batch of keys, as
``fold_in`` over a tensor of data gives). Element ``i`` of a draw of
``shape`` hashes the counter pair ``(i >> 32, i & 0xFFFFFFFF)`` of its
row-major index under the key, and its 32 random bits are the two output
words XORed. Values are held in int64 tensors, masked to 32 bits.

``gumbel`` is ``−log(−log(u))`` in float32 over ``uniform(minval=tiny)``,
as ``jax.random.gumbel``'s default ``"low"`` mode computes it; ``log``
is torch's, which differs from XLA's by a float32 step at some inputs,
so a score may differ in its last bits while the uniform draws equal.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

_MASK32 = 0xFFFFFFFF
_ONE_BITS = 0x3F800000  # float32 1.0

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k1: Word, k2: Word, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry-2x32 hash (20 rounds) of counter pairs ``(x0, x1)``
    under key ``(k1, k2)``, on int64 tensors holding uint32 values
    (``jax.random``'s ``threefry2x32`` primitive). Key words broadcast
    against the counters."""
    ks = [k1, k2, k1 ^ k2 ^ 0x1BD11BDA]
    rotations = [(13, 15, 26, 6), (17, 29, 16, 24)]
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the seed's high and low words."""
    return (seed >> 32) & _MASK32, seed & _MASK32


def _scalar(word: int) -> torch.Tensor:
    return torch.tensor([word], dtype=torch.int64)


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in(key, data)``: the hash of the pair ``(0,
    data)``. ``data`` an int gives a key of ints; a tensor of ints gives a
    batch of keys of its shape, on its device."""
    if isinstance(data, torch.Tensor):
        lo = data.to(torch.int64) & _MASK32
        return threefry2x32(*key, torch.zeros_like(lo), lo)
    b0, b1 = threefry2x32(*key, _scalar(0), _scalar(data & _MASK32))
    return int(b0), int(b1)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` for a key of ints: key ``i`` is the
    hash of the pair ``(0, i)``."""
    b0, b1 = threefry2x32(*key, torch.zeros(num, dtype=torch.int64),
                          torch.arange(num, dtype=torch.int64))
    return tuple((int(a), int(b)) for a, b in zip(b0.tolist(), b1.tolist()))


def random_bits(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """The 32 random bits (int64) of each element of a draw of ``shape``;
    a batch of keys of shape B gives bits of shape B + ``shape``."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    index = torch.arange(size, dtype=torch.int64, device=device)
    k1, k2 = key
    if isinstance(k1, torch.Tensor):
        batch = k1.shape
        k1 = k1.to(device).reshape(-1, 1)
        k2 = k2.to(device).reshape(-1, 1)
    else:
        batch = ()
    b0, b1 = threefry2x32(k1, k2, index >> 32, index & _MASK32)
    return (b0 ^ b1).reshape(batch + shape)


def uniform(key: Key, shape: Sequence[int], device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1, then
    ``floats·(maxval − minval) + minval`` as one fused multiply-add (XLA
    contracts it so: the float64 product of two float32 values is exact,
    and the sum is rounded to float32 at the end), held at ``minval`` from
    below."""
    bits = random_bits(key, shape, device)
    floats = (((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).to(torch.float32)
    return torch.maximum(lo, scaled)


def gumbel(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (float32, ``"low"`` mode)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, device, minval=tiny, maxval=1.0)))


def jax_uniform_mantissas(seed: int, size: int, device) -> torch.Tensor:
    """The 23-bit mantissas of ``jax.random.uniform(PRNGKey(seed),
    (size,))`` as int64. The float32 uniform is mantissa·2⁻²³, so these
    order the draws exactly."""
    return random_bits(prng_key(seed), (size,), device) >> 9


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k(scores, k)[1]`` over the last axis: the indices of
    the ``k`` largest, largest first, and among equal scores the lower
    index first (a stable descending sort; ``torch.topk`` leaves the order
    of ties unspecified)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]
