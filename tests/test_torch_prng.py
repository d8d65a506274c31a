"""The port's threefry2x32 (`repro_torch.fleetsim.prng`) bit for bit against
`jax.random` as installed (threefry partitionable, 64-bit types off):
`PRNGKey`, `split`, `fold_in`, the 32-bit bits and `uniform` over 200
seeds (0, 2**31 - 1, 2**32, 2**63 - 1 and negatives among them) and the
shapes (), (1,), (7,), (3, 5), (100_003,), plus known answers of the
cipher itself.  The reference runs under `jax.jit`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from repro_torch.fleetsim import prng  # noqa: E402

_M = 0xFFFFFFFF
SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32, 2 ** 32 + 5, 2 ** 63 - 1, -1,
         -(2 ** 31)] + [int(s) for s in np.random.default_rng(17).integers(
             0, 2 ** 63 - 1, 191, dtype=np.int64)]
SHAPES = [(), (1,), (7,), (3, 5), (100_003,)]
_SPLIT = jax.jit(jax.random.split, static_argnums=1)
_FOLD = jax.jit(jax.random.fold_in)
_UNIFORM = jax.jit(jax.random.uniform, static_argnums=1)
_BITS = jax.jit(lambda k, s: jax.random.bits(k, s, jnp.uint32),
                static_argnums=1)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _key(seed):
    return prng.PRNGKey(seed, "cpu")


def _words(x):
    """uint32 numpy words of a jax array, or of the port's int64 tensor."""
    if isinstance(x, torch.Tensor):
        v = x.numpy()
        assert v.dtype == np.int64 and v.min(initial=0) >= 0 \
            and v.max(initial=0) <= _M
        return v.astype(np.uint32)
    return np.asarray(x)


def test_known_answers():
    """The cipher's own test vectors, and jax 0.9's outputs for key 0."""
    def tf(k, x):
        a, b = prng.threefry2x32(torch.tensor(k, dtype=torch.int64),
                                 torch.tensor([x[0]], dtype=torch.int64),
                                 torch.tensor([x[1]], dtype=torch.int64))
        return int(a), int(b)
    assert tf((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3)) == \
        (0xc4923a9c, 0x483df7a0)
    assert tf((0, 0), (0, 0)) == (0x6b200159, 0x99ba4efe)
    assert tf((_M, _M), (_M, _M)) == (0x1cb996fc, 0xbb002be7)
    k0 = _key(0)
    assert prng.split(k0).tolist() == [[1797259609, 2579123966],
                                       [928981903, 3453687069]]
    assert prng.fold_in(k0, 0xFA).tolist() == [2774691040, 2925814535]
    u = prng.uniform(prng.split(k0)[1], (4,)).numpy()
    # the printed decimals, and the exact floats
    np.testing.assert_allclose(u, [0.00729382, 0.02089119, 0.5814265,
                                   0.36183798], rtol=1e-6)
    np.testing.assert_array_equal(u, np.asarray(_UNIFORM(
        _SPLIT(jax.random.PRNGKey(0), 2)[1], (4,))))


def test_threefry_matches_jax_primitive():
    """The cipher on random keys and counter pairs == jax's primitive."""
    rng = np.random.default_rng(5)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 1000), dtype=np.uint64).astype(
        np.uint32)
    want = jax.jit(jprng.threefry2x32_p.bind)(*map(jnp.asarray,
                                                   (k[0], k[1], x[0], x[1])))
    got = prng.threefry2x32(*(torch.as_tensor(a.astype(np.int64))
                              for a in (k, x[0], x[1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_words(g), np.asarray(w))


def test_prng_key_split_fold_in_match_jax_over_seeds():
    for seed in SEEDS:
        key = _key(seed)
        jkey = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(_words(key), np.asarray(jkey),
                                      err_msg=str(seed))
        for num in (2, 3):
            np.testing.assert_array_equal(
                _words(prng.split(key, num)), np.asarray(_SPLIT(jkey, num)),
                err_msg=f"split {seed} {num}")
        for d in (0, 1, 0xFA, _M, seed & _M):
            np.testing.assert_array_equal(
                _words(prng.fold_in(key, d)),
                np.asarray(_FOLD(jkey, np.uint32(d))),
                err_msg=f"fold_in {seed} {d}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_match_jax_over_seeds(shape):
    """Draws of every shape from each seed's second split key (the key a
    churn or burst-chain draw uses), bitwise."""
    for seed in SEEDS:
        sub = prng.split(_key(seed))[1]
        jsub = _SPLIT(jax.random.PRNGKey(seed), 2)[1]
        u = prng.uniform(sub, shape)
        assert u.dtype == torch.float32 and tuple(u.shape) == shape
        np.testing.assert_array_equal(u.numpy(),
                                      np.asarray(_UNIFORM(jsub, shape)),
                                      err_msg=str(seed))
        if shape in ((7,), (3, 5)):
            np.testing.assert_array_equal(
                _words(prng.random_bits(sub, shape)),
                np.asarray(_BITS(jsub, shape)), err_msg=str(seed))


def test_chained_draws_match_jax():
    """The churn pattern, key -> (key, sub) -> uniform(sub), over 50
    epochs: the carried key and every draw stay bitwise equal."""
    key, jkey = _key(9), jax.random.PRNGKey(9)
    for _ in range(50):
        key, sub = prng.split(key)
        jkey, jsub = _SPLIT(jkey, 2)
        np.testing.assert_array_equal(prng.uniform(sub, (33,)).numpy(),
                                      np.asarray(_UNIFORM(jsub, (33,))))
    np.testing.assert_array_equal(_words(key), np.asarray(jkey))
