"""K3's arithmetic (the GF(2^8) product behind RS encode and decode) on
the CPU, against the JAX reference.

The card's kernel (`uno_gf_matmul`, csrc/unorc_kernels.cu) runs Horner
over the coefficient bits on packed 32-bit words: out_m = sum_b 2^b
S_{m,b}, S_{m,b} the XOR of the x_k whose coefficient has bit b set,
with the coefficients as the word masks of `unorc_cuda.gf_planes`.
`_horner_replay` repeats that arithmetic in PyTorch, reading the same
mask block, so that what the kernel computes is held here bitwise
against the port's plain version (`ref.gf_matmul_ref`, log/exp tables),
the reference's (`repro.kernels.ref.gf_matmul_ref`) and the Pallas
kernel in interpret mode (`rs_pallas.gf_matmul`), at the encode rows,
every RS(8, 2) erasure pattern, seeded random matrices of every shape
the kernel takes, and the edge coefficients.  The card tests
(test_torch_kernels_gpu.py) hold the kernel against the plain version.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as RK  # noqa: E402
from repro.kernels import rs_pallas  # noqa: E402

from repro_torch.kernels import gf as TG  # noqa: E402
from repro_torch.kernels import ref as TK  # noqa: E402
from repro_torch.kernels import unorc_cuda  # noqa: E402

WIDTH = rs_pallas.TILE_B          # the Pallas kernel takes whole tiles
BITS = unorc_cuda.GF_BITS
WORD = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _xtime4(v):
    """Multiply by 2 in GF(2^8) on the four bytes of each 32-bit word, as
    the kernel writes it: 2 v ^ 2 hi ^ ((hi * (0x1D << 25)) >> 32), hi the
    bytes' top bits, mod 2^32."""
    hi = v & 0x80808080
    return ((v * 2) ^ (hi * 2) ^ ((hi * (0x1D << 25)) >> 32)) & WORD


def _horner_replay(coeffs, x):
    """The kernel's arithmetic: x (..., K, B) uint8, B % 4 == 0, read as
    little-endian 32-bit words (held in int64, so no step overflows);
    for each output row m, acc = 0, then for b = 7 .. 0: double acc if
    `dbl` says a plane above b is live, and if `live` says plane (m, b)
    is, XOR in x_k selected by word[m][b][k] for every k, as x_k & word
    or, for the k of `GF_MUL_K`, as x_k * word mod 2^32."""
    block = unorc_cuda.gf_planes(coeffs).astype(np.int64)
    words = torch.from_numpy(block[:-2].reshape(unorc_cuda.MAX_M, BITS,
                                                unorc_cuda.MAX_K))
    live, dbl = int(block[-2]), int(block[-1])
    v = x.contiguous().view(torch.int32).long() & WORD
    rows = []
    for m in range(len(coeffs)):
        acc = torch.zeros_like(v[..., 0, :])
        for b in range(BITS - 1, -1, -1):
            plane = 1 << (BITS * m + b)
            if dbl & plane:
                acc = _xtime4(acc)
            if live & plane:
                for k in range(x.shape[-2]):
                    w = words[m, b, k]
                    term = (v[..., k, :] * w) & WORD \
                        if unorc_cuda.GF_MUL_K[k] else v[..., k, :] & w
                    acc = acc ^ term
        rows.append(acc)
    words = torch.stack(rows, dim=-2)
    words = torch.where(words > 0x7FFFFFFF, words - (1 << 32), words)
    return words.to(torch.int32).view(torch.uint8)


def _erasure_cases():
    """Each of the 55 patterns of one or two lost rows among the ten of
    RS(8, 2): the decode matrix of its lost data rows, or, where only
    parity rows are lost, the generator rows that re-encode them."""
    k, r = 8, 2
    gen = TG.rs_generator_rows(k, r)
    for m in (1, 2):
        for lost in itertools.combinations(range(k + r), m):
            missing = tuple(i for i in lost if i < k)
            avail = tuple(j for j in range(r) if k + j not in lost)
            coeffs = (TG.rs_decode_matrix(k, r, missing, avail) if missing
                      else tuple(gen[i - k] for i in lost))
            yield pytest.param(coeffs, id=f"lost{'-'.join(map(str, lost))}")


def _random_cases():
    for m in range(1, unorc_cuda.MAX_M + 1):
        for k in (1, 2, 7, 8, 9, 16):
            rng = np.random.default_rng(100 * m + k)
            c = rng.integers(0, 256, (m, k))
            c[rng.random((m, k)) < 0.2] = 0
            yield pytest.param(tuple(map(tuple, c.tolist())),
                               id=f"random{m}x{k}")


def _edge_cases():
    """A constant coefficient in a (3, 9) matrix, one row of it zeroed:
    0 (no live plane), 1 (plane 0 only), 0x80 (plane 7 only, doubled
    seven times), 0xFF (every plane)."""
    for c in (0, 1, 0x80, 0xFF):
        yield pytest.param(((c,) * 9, (0,) * 9, (c, 0) * 4 + (c,)),
                           id=f"coeff{c:#04x}")


CASES = [pytest.param(TG.rs_generator_rows(8, 2), id="encode"),
         *_erasure_cases(), *_random_cases(), *_edge_cases()]


def test_case_count():
    assert len(CASES) == 1 + 55 + 24 + 4


@pytest.mark.parametrize("coeffs", CASES)
def test_horner_replay_matches_reference_and_pallas(coeffs):
    """The mask block decodes back to the coefficients, and the replay of
    the kernel's arithmetic over two groups of (K, 2048) bytes is bitwise
    equal to the plain versions and to the Pallas kernel."""
    m, k = len(coeffs), len(coeffs[0])
    block = unorc_cuda.gf_planes(coeffs)
    words = block[:-2].reshape(unorc_cuda.MAX_M, BITS, unorc_cuda.MAX_K)
    mul = unorc_cuda.GF_MUL_K
    assert set(np.unique(words[..., ~mul]).tolist()) <= {0, WORD}
    assert set(np.unique(words[..., mul]).tolist()) <= {0, 1}
    weights = (1 << np.arange(BITS))[None, :, None]
    assert ((words[:m, :, :k] != 0) * weights).sum(axis=1).tolist() == \
        [list(row) for row in coeffs]
    assert not words[m:].any() and not words[:, :, k:].any()

    x = np.random.default_rng(7 * m + k).integers(0, 256, (2, k, WIDTH),
                                                  dtype=np.uint8)
    x[0, :, :3] = (0, 0x80, 0xFF)
    xt = torch.from_numpy(x)
    got = _horner_replay(coeffs, xt)
    assert got.shape == (2, m, WIDTH) and got.dtype == torch.uint8
    assert torch.equal(got, TK.gf_matmul_ref(coeffs, xt))
    assert torch.equal(got, unorc_cuda.gf_matmul(xt, coeffs))
    c = jnp.asarray(np.array(coeffs, dtype=np.uint8))
    for g in range(2):
        want = np.asarray(RK.gf_matmul_ref(c, jnp.asarray(x[g])))
        assert np.array_equal(got[g].numpy(), want), ("reference", g)
        want = np.asarray(rs_pallas.gf_matmul(jnp.asarray(x[g]), coeffs,
                                              interpret=True))
        assert np.array_equal(got[g].numpy(), want), ("pallas", g)
