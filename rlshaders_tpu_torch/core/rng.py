"""Counter-based random streams, bit-exact with the JAX package.

Counterpart of rlshaders_tpu/core/rng.py. Two generators:

* Owen-scrambled Sobol (0,2) points (`sobol2`, `sobol2_flat`): per-pixel
  jointly stratified samples keyed on (pixel, purpose, salt).
* A twin of `jax.random`'s threefry2x32 (`PRNGKey`, `fold_in`, `split`,
  `bits`, `uniform`), matching jax 0.9 with `jax_threefry_partitionable`
  on, so that a render draws the same numbers as the JAX render.

Keys are int64 tensors of shape (2,) holding two uint32 words, kept on the
CPU: deriving a key is a few scalar hashes, and `bits` reads the two words
as Python ints to hash a counter tensor on any device. There is no global
generator state.

All uint32 arithmetic runs in int64 under `& 0xFFFFFFFF`: torch's uint32
has no shift or multiply kernels on the CPU. Products of two 32-bit words
are split into 16-bit halves so that no intermediate leaves int64.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# uint32 helpers on int64 tensors
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


# ---------------------------------------------------------------------------
# threefry2x32 (jax._src.prng._threefry2x32_lowering)
# ---------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block hash (20 rounds) of counter pairs (x0, x1)
    under key words (k0, k1); all values uint32 held in int64."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _words(key: torch.Tensor) -> tuple[int, int]:
    k = key.tolist()
    return int(k[0]), int(k[1])


def PRNGKey(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey for a 32-bit seed: the words (0, seed)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in: hash the counter pair (0, data) under key."""
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(
        k0, k1, torch.zeros(1, dtype=torch.int64),
        torch.tensor([int(data) & M32], dtype=torch.int64),
    )
    return torch.cat([y0, y1])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (fold-like, partitionable): (num, 2) keys, key i
    being the hash of the counter pair (0, i)."""
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(
        k0, k1, torch.zeros(num, dtype=torch.int64),
        torch.arange(num, dtype=torch.int64),
    )
    return torch.stack([y0, y1], dim=1)


def bits(key: torch.Tensor, shape: tuple[int, ...],
         device="cpu") -> torch.Tensor:
    """jax.random.bits(key, shape, uint32), as int64 tensor of uint32
    values: element j (row-major) is the xor of the two hash words of the
    counter pair (0, j)."""
    k0, k1 = _words(key)
    n = 1
    for s in shape:
        n *= s
    lo = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return (y0 ^ y1).reshape(shape)


def uniform(key: torch.Tensor, shape: tuple[int, ...],
            device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) on [0, 1): the top 23 bits
    as the mantissa of a float in [1, 2), minus one."""
    b = bits(key, shape, device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)


def bits_scalar(key: torch.Tensor) -> int:
    """jax.random.bits(key, (), uint32) as a Python int."""
    return int(bits(key, ()).item())


# ---------------------------------------------------------------------------
# Render-level helpers (rlshaders_tpu.core.rng's stream/fold/uniform2/...)
# ---------------------------------------------------------------------------


def stream(seed: int) -> torch.Tensor:
    """Root key for a render."""
    return PRNGKey(seed)


def fold(key: torch.Tensor, *ids: int) -> torch.Tensor:
    """Derive a subkey from integer identifiers."""
    for i in ids:
        key = fold_in(key, i)
    return key


def uniform2(key: torch.Tensor, shape: tuple[int, ...],
             device="cpu") -> torch.Tensor:
    """Uniform (..., 2) samples in [0, 1)."""
    return uniform(key, tuple(shape) + (2,), device)


def stratified2_flat(key: torch.Tensor, n: int, s: int,
                     device="cpu") -> torch.Tensor:
    """(s*s*n, 2) stratified samples in SAMPLE-MAJOR flat layout: row
    k*n + i is element i's jittered sample in stratum (k % s, k // s)."""
    count = s * s
    jitter = uniform(key, (count, n, 2), device)
    k = torch.arange(count, dtype=torch.float32, device=device)
    sx = torch.remainder(k, s)
    sy = torch.floor(k / s)
    base = torch.stack([sx, sy], dim=-1)[:, None, :]
    return ((base + jitter) / float(s)).reshape(count * n, 2)


# ---------------------------------------------------------------------------
# Owen-scrambled Sobol (0,2)-sequence
# ---------------------------------------------------------------------------


def _sobol_dir2() -> tuple[int, ...]:
    v = 1 << 31
    out = []
    for _ in range(32):
        out.append(v)
        v ^= v >> 1
    return tuple(out)


_DIR2 = _sobol_dir2()


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 integer hash (uint32 -> uint32)."""
    x = x & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _reverse32(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def _lk_permute(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras hash permutation: an Owen scramble in reversed-bit
    order."""
    x = (x + seed) & M32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def _owen(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Nested uniform (Owen) scramble of an MSB-first digit string."""
    return _reverse32(_lk_permute(_reverse32(x), seed))


def _sobol_d1(idx: torch.Tensor, nbits: int = 16) -> torch.Tensor:
    """Second Sobol dimension (MSB-aligned uint32) for indices < 2^nbits."""
    y = torch.zeros_like(idx)
    for b in range(nbits):
        y = y ^ (((idx >> b) & 1) * _DIR2[b])
    return y


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    # keep 24 mantissa-exact bits; result in [0, 1)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sobol2(idx: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Owen-scrambled Sobol (0,2) points: idx (N,) global sample indices,
    seed (N,) per-stream scramble ids (int64 holding uint32). Returns
    (N, 2) float32."""
    idx = idx.to(torch.int64) & M32
    sx = _hash_u32(seed)
    sy = _hash_u32(seed ^ 0x9E3779B9)
    d0 = _owen(_reverse32(idx), sx)
    d1 = _owen(_sobol_d1(idx), sy)
    return torch.stack([_to_unit(d0), _to_unit(d1)], dim=-1)


def _stream_seed(pix: torch.Tensor, purpose: int, salt: int) -> torch.Tensor:
    """Per-(pixel, purpose) scramble seed."""
    p = _hash_u32(torch.tensor(int(purpose) & M32, dtype=torch.int64))
    return _hash_u32((pix.to(torch.int64) & M32) ^ int(p) ^ (int(salt) & M32))


def sobol2_flat(pix: torch.Tensor, aa: torch.Tensor, s_count: int,
                purpose: int, salt: int) -> torch.Tensor:
    """(s_count*N, 2) per-pixel jointly-stratified samples, COLUMN-major:
    row c*N + i is lane i's c-th sample, with global sequence index
    aa[i]*s_count + c in lane i's (pixel, purpose) stream."""
    c = torch.arange(s_count, dtype=torch.int64, device=pix.device)
    idx = (aa.to(torch.int64)[None, :] * s_count + c[:, None]).reshape(-1)
    seed = _stream_seed(pix, purpose, salt).repeat(s_count)
    return sobol2(idx, seed)
