"""The port's random streams are bit-equal to the JAX package's.

Owen-Sobol (rlshaders_tpu.core.rng) and the threefry2x32 twin of
jax.random (jax 0.9, jax_threefry_partitionable on) must agree bit for
bit: a render of the port then draws the same samples as the JAX render.
Tolerance: none (exact equality of uint32 words and float32 values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlshaders_tpu.core import rng as jrng
from rlshaders_tpu_torch.core import rng as trng

SEEDS = [0, 1, 100, 12345, 2**31 - 1]


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64)


def _t(x) -> np.ndarray:
    return x.numpy().astype(np.uint64)


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_split(seed):
    jk = jax.random.PRNGKey(seed)
    tk = trng.PRNGKey(seed)
    np.testing.assert_array_equal(_t(tk), _u32(jk))
    for data in (0, 1, 7, 77, 1000, 3141, 4242, 2**32 - 1):
        np.testing.assert_array_equal(
            _t(trng.fold_in(tk, data)),
            _u32(jax.random.fold_in(jk, np.uint32(data))))
    np.testing.assert_array_equal(
        _t(trng.fold(tk, 101, 3, 9)), _u32(jrng.fold(jk, 101, 3, 9)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(
            _t(trng.split(tk, num)), _u32(jax.random.split(jk, num)))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (4, 3, 2)])
def test_bits_and_uniform(shape):
    jk = jrng.fold(jax.random.PRNGKey(100), 1000, 3)
    tk = trng.fold(trng.PRNGKey(100), 1000, 3)
    np.testing.assert_array_equal(
        _t(trng.bits(tk, shape)),
        _u32(jax.random.bits(jk, shape, jnp.uint32)))
    ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    tu = trng.uniform(tk, shape).numpy()
    assert tu.dtype == np.float32
    np.testing.assert_array_equal(tu, ju)
    assert trng.bits_scalar(tk) == int(jax.random.bits(jk, (), jnp.uint32))


def test_uniform2_and_stratified2_flat():
    jk = jax.random.PRNGKey(5)
    tk = trng.PRNGKey(5)
    np.testing.assert_array_equal(trng.uniform2(tk, (33,)).numpy(),
                                  np.asarray(jrng.uniform2(jk, (33,))))
    for s in (1, 2, 3):
        np.testing.assert_array_equal(
            trng.stratified2_flat(tk, 17, s).numpy(),
            np.asarray(jrng.stratified2_flat(jk, 17, s)))


def test_owen_sobol_building_blocks():
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    seed = np.random.default_rng(1).integers(0, 2**32, 4096, dtype=np.uint64)
    tx = torch.tensor(x.astype(np.int64))
    ts = torch.tensor(seed.astype(np.int64))
    jx = jnp.asarray(x.astype(np.uint32))
    js = jnp.asarray(seed.astype(np.uint32))
    np.testing.assert_array_equal(_t(trng._hash_u32(tx)),
                                  _u32(jrng._hash_u32(jx)))
    np.testing.assert_array_equal(_t(trng._reverse32(tx)),
                                  _u32(jrng._reverse32(jx)))
    np.testing.assert_array_equal(_t(trng._lk_permute(tx, ts)),
                                  _u32(jrng._lk_permute(jx, js)))
    np.testing.assert_array_equal(_t(trng._owen(tx, ts)),
                                  _u32(jrng._owen(jx, js)))
    idx = np.arange(4096, dtype=np.uint32)
    np.testing.assert_array_equal(
        _t(trng._sobol_d1(torch.tensor(idx.astype(np.int64)))),
        _u32(jrng._sobol_d1(jnp.asarray(idx))))


def test_sobol2_and_flat_streams():
    rs = np.random.default_rng(2)
    idx = rs.integers(0, 2**16, 2000).astype(np.uint32)
    seed = rs.integers(0, 2**32, 2000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        trng.sobol2(torch.tensor(idx.astype(np.int64)),
                    torch.tensor(seed.astype(np.int64))).numpy(),
        np.asarray(jrng.sobol2(jnp.asarray(idx), jnp.asarray(seed))))

    # padding lanes carry pixel -1
    pix = np.concatenate([np.arange(0, 500, dtype=np.int32), [-1, -1]])
    aa = (np.arange(pix.size) % 4).astype(np.int32)
    salt = int(jax.random.bits(jax.random.PRNGKey(9), (), jnp.uint32))
    for purpose in (101 << 8, (101 << 8) + 1, 501 << 8, 601 << 8):
        np.testing.assert_array_equal(
            _t(trng._stream_seed(torch.tensor(pix), purpose, salt)),
            _u32(jrng._stream_seed(jnp.asarray(pix), purpose,
                                   jnp.uint32(salt))))
        for s_count in (1, 4):
            np.testing.assert_array_equal(
                trng.sobol2_flat(torch.tensor(pix), torch.tensor(aa),
                                 s_count, purpose, salt).numpy(),
                np.asarray(jrng.sobol2_flat(jnp.asarray(pix),
                                            jnp.asarray(aa), s_count,
                                            purpose, salt)))
