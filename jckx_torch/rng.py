"""jax's default random numbers in tensor ops: ``PRNGKey(seed)`` → ``bits``,
``uniform`` and ``normal``, as JAX 0.9 draws them with
``jax_threefry_partitionable`` on (its default).

jckx's exported sampler draws its z inside the program as
``jax.random.normal(jax.random.PRNGKey(seed), (bs, z_dim))``
(``jckx/export.py:92-103``); the port's artifact (``jckx_torch/export.py``)
draws the same z from the same seed with ``normal_from_seed``. Everything
here is int64 / float32 torch arithmetic on tensors, so ``torch.export``
traces it and it runs on any device:

- the key of a seed s is the pair (0, s mod 2³²): jax takes the seed as
  an int32 (``jax._src.prng._threefry_seed``);
- Threefry-2x32 with 20 rounds (``_threefry2x32_lowering``), each uint32
  word held in an int64 and masked to 32 bits after every add and shift
  (torch has no usable uint32 arithmetic);
- the partitionable counter layout (``iota_2x32_shape``): element i of the
  output hashes the pair (i >> 32, i mod 2³²), and its 32 random bits are
  the xor of the two output words (``_threefry_random_bits_partitionable``);
- uniform in [lo, hi) from the top 23 bits as a float in [1, 2) minus 1,
  scaled, shifted and clamped below at lo (``jax._src.random._uniform``);
- normal = √2 · erfinv(u) with u uniform in [nextafter(-1, 0), 1)
  (``_normal_real``), where erfinv is XLA's float32 one: Giles' two
  polynomials in w = -log1p(-u²), split at w = 5 (``erf_inv``'s
  decomposition in StableHLO's CHLO). ``torch.erfinv`` differs from it by
  up to ~2e-5 in the tails. The bits and uniforms equal jax's exactly;
  the normals agree to a few float32 ulps (log1p and sqrt are each
  library's own).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# the float32 just above -1, normal's lower bound for the uniform
_NEXT_ABOVE_MINUS_ONE = -1.0 + 2.0 ** -24
# Giles' erfinv coefficients, highest order first, for w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2). Every argument is an int64 tensor of uint32
    values (broadcastable); → the two int64 output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key_from_seed(seed) -> tuple:
    """``jax.random.PRNGKey(seed)`` as two int64 scalars (high, low word).
    ``seed`` is a Python int or an integer tensor of one element. jax (64-bit
    mode off, its default) takes the seed as an int32, so the high word is 0
    and the low word is the seed mod 2³² (PRNGKey(-3) = (0, 2³² - 3))."""
    lo = torch.as_tensor(seed).reshape(()).to(torch.int64) & _MASK
    return torch.zeros_like(lo), lo


def bits(key: tuple, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in [0, 2³²),
    on the key's device."""
    k1, k2 = key
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return (y1 ^ y2).reshape(tuple(shape))


def uniform(key: tuple, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    b = bits(key, shape)
    # the top 23 bits as the mantissa of a float in [1, 2); the value fits
    # an int32 (sign bit clear), whose bits reinterpret as that float
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (see the module docstring); ±1 → ±inf."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = torch.where(small, cs, cl) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: tuple, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape)``, float32."""
    u = uniform(key, shape, _NEXT_ABOVE_MINUS_ONE, 1.0)
    return erfinv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32, device=u.device)


def normal_from_seed(seed, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)``: the z an
    exported sampler draws for ``seed``, on ``device`` (default: the seed
    tensor's, else the CPU)."""
    k1, k2 = key_from_seed(seed)
    if device is not None:
        k1, k2 = k1.to(device), k2.to(device)
    return normal((k1, k2), shape)
