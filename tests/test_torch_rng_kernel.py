"""The random draws' kernel arithmetic equals core/rng.py's plain version.

`ops/csrc/rng.cuh` holds every step of the CUDA draws (ops/rng.py). Here,
with no card and no nvcc, g++ compiles it through `ops/csrc/rng_host.cpp`,
which loops over the kernels' elements as their threads do, and every
element is held to core/rng.py's int64 tensor code on the CPU. Tolerance:
none (equal uint32 words and float32 bits). Also: the tracer's counters of
the draws. The CUDA kernels themselves are held to the CPU draws in
tests/test_torch_gpu.py.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

from rlshaders_tpu_torch.accel import native
from rlshaders_tpu_torch.core import rng, tracer
from rlshaders_tpu_torch.ops import rng as kernels

CSRC = os.path.join(os.path.dirname(kernels.__file__), "csrc")
M32 = 0xFFFFFFFF

# random words across the uint32 range, and the edges
_RS = np.random.default_rng(23)
KEYS = [(0, 0), (0, 5), (M32, M32), (0x1BD11BDA, 1)] + [
    tuple(int(w) for w in _RS.integers(0, 2**32, 2, dtype=np.uint64))
    for _ in range(4)]
SALTS = [0, M32, 0x9E3779B9, int(_RS.integers(0, 2**32, dtype=np.uint64))]


@pytest.fixture(scope="module")
def host():
    lib = ctypes.CDLL(native.build(
        native.EXACT_FLAGS, os.path.join(CSRC, "rng_host.cpp"),
        "librls_rng_host", headers=(os.path.join(CSRC, "rng.cuh"),)))
    p, i, u32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_int64)
    lib.rls_rng_threefry.argtypes = [u32, u32, i64, i, i, i64, p]
    lib.rls_rng_sobol_stream.argtypes = [p, i, p, i, i64, i, i, u32, p]
    lib.rls_rng_sobol_at.argtypes = [p, i, p, i, p, i64, i, u32, i, p]
    for f in (lib.rls_rng_threefry, lib.rls_rng_sobol_stream,
              lib.rls_rng_sobol_at):
        f.restype = i
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _threefry(lib, key, n, mode, s=1, lanes=1) -> np.ndarray:
    out = np.zeros(n, np.int64 if mode == kernels.BITS else np.float32)
    k0, k1 = (int(w) for w in key.tolist())
    assert lib.rls_rng_threefry(k0, k1, n, mode, s, lanes, _ptr(out)) == 0
    return out


def _lane(x: np.ndarray):
    x = np.ascontiguousarray(x)
    return x, int(x.dtype == np.int64)


def _stream(lib, pix, aa, s, lane_major, key) -> np.ndarray:
    (pix, p64), (aa, a64) = _lane(pix), _lane(aa)
    out = np.zeros((pix.shape[0] * s, 2), np.float32)
    assert lib.rls_rng_sobol_stream(_ptr(pix), p64, _ptr(aa), a64,
                                    pix.shape[0], s, int(lane_major), key,
                                    _ptr(out)) == 0
    return out


def _at(lib, pix, idx, key, purposes=None, seeded=False) -> np.ndarray:
    (pix, p64), (idx, i64) = _lane(pix), _lane(idx)
    k = 1 if purposes is None else purposes.shape[0]
    pp = None if purposes is None else _ptr(purposes)
    out = np.zeros((pix.shape[0] * k, 2), np.float32)
    assert lib.rls_rng_sobol_at(_ptr(pix), p64, _ptr(idx), i64, pp,
                                pix.shape[0], k, key, int(seeded),
                                _ptr(out)) == 0
    return out


def _key(words) -> torch.Tensor:
    return torch.tensor(list(words), dtype=torch.int64)


def _bits32(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _equal(got: np.ndarray, want: torch.Tensor) -> None:
    want = want.numpy()
    assert got.dtype == want.dtype and got.size == want.size
    if got.dtype == np.float32:
        np.testing.assert_array_equal(_bits32(got).ravel(),
                                      _bits32(want).ravel())
    else:
        np.testing.assert_array_equal(got.ravel(), want.ravel())


# ---------------------------------------------------------------------------
# threefry draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("words", KEYS)
@pytest.mark.parametrize("n", [1, 7, 4099])
def test_bits_and_uniform(host, words, n):
    key = _key(words)
    _equal(_threefry(host, key, n, kernels.BITS), rng.bits(key, (n,)))
    _equal(_threefry(host, key, n, kernels.UNIFORM), rng.uniform(key, (n,)))


@pytest.mark.parametrize("seed", [0, 1, 100, 12345, 2**31 - 1])
def test_folded_keys_as_the_render_draws(host, seed):
    # test_torch_rng.py's keys: a folded key, shapes of every rank
    key = rng.fold(rng.PRNGKey(seed), 1000, 3)
    for shape in [(), (1,), (7,), (3, 5), (4, 3, 2)]:
        n = int(np.prod(shape))
        _equal(_threefry(host, key, n, kernels.BITS),
               rng.bits(key, shape).reshape(-1))
        _equal(_threefry(host, key, n, kernels.UNIFORM),
               rng.uniform(key, shape).reshape(-1))
    _equal(_threefry(host, key, 66, kernels.UNIFORM),
           rng.uniform2(key, (33,)).reshape(-1))


@pytest.mark.parametrize("words", KEYS[:4])
@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 17, 1000])
def test_stratified2_flat(host, words, s, n):
    key = _key(words)
    got = _threefry(host, key, s * s * n * 2, kernels.STRAT_FLAT, s, n)
    _equal(got, rng.stratified2_flat(key, n, s).reshape(-1))


@pytest.mark.parametrize("s", [1, 2, 3, 5])
@pytest.mark.parametrize("batch", [(1,), (13,), (4, 6)])
def test_stratified2_batch_major(host, s, batch):
    key = rng.fold(rng.PRNGKey(7), 1)
    n = int(np.prod(batch)) * s * s * 2
    got = _threefry(host, key, n, kernels.STRAT_BATCH, s)
    _equal(got, rng.stratified2(key, batch, s).reshape(-1))


# ---------------------------------------------------------------------------
# Owen-Sobol draws
# ---------------------------------------------------------------------------

# indices at and past 2^16, where the second dimension stops counting bits
EDGE_IDX = [0, 1, 2**16 - 1, 2**16, 2**16 + 1, 2**17 + 5, 2**31,
            2**32 - 1]


@pytest.mark.parametrize("part", range(4))
def test_sobol2_across_uint32(host, part):
    rs = np.random.default_rng(100 + part)
    idx = rs.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.int64)
    seed = rs.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.int64)
    idx[:len(EDGE_IDX)] = EDGE_IDX
    seed[:4] = [0, 1, 2**31, M32]
    got = _at(host, seed, idx, 0, seeded=True)
    _equal(got, rng.sobol2(torch.tensor(idx), torch.tensor(seed)))


def test_sobol2_small_indices(host):
    # test_torch_rng.py's case: indices below 2^16
    rs = np.random.default_rng(2)
    idx = rs.integers(0, 2**16, 2000).astype(np.int64)
    seed = rs.integers(0, 2**32, 2000, dtype=np.uint64).astype(np.int64)
    _equal(_at(host, seed, idx, 0, seeded=True),
           rng.sobol2(torch.tensor(idx), torch.tensor(seed)))


def _lanes(dtype, n=500):
    """Pixels with padding lanes (pixel -1) and AA indices, some past
    2^16 / s_count so that the stream index passes 2^16."""
    pix = np.concatenate([np.arange(n, dtype=np.int64), [-1, -1, M32]])
    aa = (np.arange(pix.size) % 9).astype(np.int64)
    aa[-6:] = [2**16 // 9, 2**16 // 4, 2**16, 2**20 + 3, 7, 2**31 - 1]
    return pix.astype(dtype), aa.astype(dtype)


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("s_count", [1, 4, 9])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_sobol2_flat_and_rep(host, salt, s_count, dtype):
    pix, aa = _lanes(dtype)
    tp, ta = torch.tensor(pix), torch.tensor(aa)
    for purpose in (101 << 8, (101 << 8) + 1, 501 << 8, M32):
        key = rng._stream_key(purpose, salt)
        _equal(_stream(host, pix, aa, s_count, False, key),
               rng.sobol2_flat(tp, ta, s_count, purpose, salt))
        _equal(_stream(host, pix, aa, s_count, True, key),
               rng.sobol2_rep(tp, ta, s_count, purpose, salt))


@pytest.mark.parametrize("salt", SALTS)
def test_sobol2_at(host, salt):
    pix, _ = _lanes(np.int32)
    rs = np.random.default_rng(salt & 0xFFFF)
    idx = rs.integers(0, 2**32, pix.size, dtype=np.uint64).astype(np.int64)
    idx[:len(EDGE_IDX)] = EDGE_IDX
    tp, ti = torch.tensor(pix), torch.tensor(idx)
    for purpose in (200, 203, M32):
        _equal(_at(host, pix, idx, rng._stream_key(purpose, salt)),
               rng.sobol2_at(tp, ti, purpose, salt))
    # the SSS stage's columns: one purpose a column
    col = np.arange(5, dtype=np.int64)
    purposes = ((100 * 0x1003) & M32) ^ ((3 * 0x10007 + col) & M32)
    got = _at(host, pix, idx, salt, purposes=purposes)
    want = rng.sobol2_at(tp, ti, torch.tensor(purposes), salt)
    assert tuple(want.shape) == (pix.size, 5, 2)
    _equal(got, want)


def test_sobol2_at_is_the_stream_seeds_draw():
    # sobol2_at is sobol2 under _stream_seed, as the SSS stage drew it
    pix = torch.tensor([0, 5, -1, 77], dtype=torch.int32)
    idx = torch.tensor([3, 2**16 + 2, 9, 2**32 - 1], dtype=torch.int64)
    purpose = torch.tensor([11, 12, 2**32 - 1], dtype=torch.int64)
    seed = rng._stream_seed(pix[:, None], purpose[None, :], 42)
    want = rng.sobol2(torch.broadcast_to(idx[:, None], (4, 3)).reshape(-1),
                      seed.reshape(-1)).reshape(4, 3, 2)
    assert torch.equal(rng.sobol2_at(pix, idx, purpose, 42), want)
    assert torch.equal(rng.sobol2_at(pix, idx, 200, 42),
                       rng.sobol2(idx, rng._stream_seed(pix, 200, 42)))


@pytest.mark.parametrize("purpose", [0, 1, 101 << 8, 2**31, M32, 2**32 + 5])
def test_stream_key_is_the_hash_of_the_purpose(purpose):
    want = int(rng._hash_u32(torch.tensor([purpose & M32]))[0])
    assert rng._hash_int(purpose) == want
    assert rng._stream_key(purpose, M32) == want ^ M32


# ---------------------------------------------------------------------------
# Dispatch and counters
# ---------------------------------------------------------------------------


def test_dispatch_is_by_device():
    assert not rng._on_card("cpu")
    assert not rng._on_card(torch.device("cpu"))
    assert rng._on_card("cuda")
    assert rng._on_card(torch.device("cuda", 0))


def _draws():
    key = rng.fold(rng.PRNGKey(3), 9)
    pix = torch.arange(10, dtype=torch.int32)
    aa = pix % 4
    return [
        rng.bits(key, (3, 2)),
        rng.uniform(key, (5,)),
        rng.uniform2(key, (7,)),
        rng.stratified2(key, (2,), 3),
        rng.stratified2_flat(key, 4, 2),
        rng.sobol2(pix.long(), pix.long() * 3),
        rng.sobol2_flat(pix, aa, 4, 101, 5),
        rng.sobol2_rep(pix, aa, 2, 102, 5),
        rng.sobol2_at(pix, aa, 103, 5),
        rng.sobol2_at(pix, aa, torch.arange(3), 5),
    ]


def test_counters_count_the_values_drawn():
    tracer.take()
    with tracer.enabled(counters=True):
        out = _draws()
        rng.bits_scalar(rng.PRNGKey(1))    # a key derivation, not a draw
        _, counters = tracer.take()
    assert counters["rng_values"] == sum(x.numel() for x in out)
    assert counters["rng_kernel_values"] == 0   # no kernel on the CPU


def test_nothing_is_counted_while_counters_are_off():
    tracer.take()
    _draws()
    with tracer.enabled(spans=True):
        _draws()
    _, counters = tracer.take()
    assert counters == {}
