"""GF(2^8) field algebra on the host: tables, integer helpers and the
Reed-Solomon coefficient solver.

Field: GF(256) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D,
generator 2), the classic Reed-Solomon field.  The exp/log tables feed the
plain PyTorch GF product (`ref.gf_matmul_ref`); the Python-int helpers
build the small static coefficient matrices (`rs_generator_rows`,
`rs_decode_matrix`) that the GF kernel takes as an argument.  The same
algebra as the reference's ``repro.kernels.gf``, kept here so the port
imports nothing of it.
"""
from __future__ import annotations

import functools

import numpy as np

POLY = 0x11D
ORDER = 255

EXP = np.zeros(512, dtype=np.int32)
LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(ORDER):
    EXP[_i] = _x
    LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= POLY
EXP[ORDER:2 * ORDER] = EXP[:ORDER]          # wraparound for a+b mod 255
EXP[2 * ORDER:] = 1


def gf_mul_int(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def gf_inv_int(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf(256) inverse of 0")
    return int(EXP[ORDER - LOG[a]])


def gf_pow_int(a: int, n: int) -> int:
    if a == 0:
        return 0 if n else 1
    return int(EXP[(LOG[a] * n) % ORDER])


def gf_solve(A: list[list[int]], B: list[list[int]]) -> list[list[int]]:
    """Solve A X = B over GF(256) by Gauss-Jordan (tiny systems only)."""
    n = len(A)
    M = [row[:] + rhs[:] for row, rhs in zip(A, B)]
    w = len(M[0])
    for col in range(n):
        piv = next((r for r in range(col, n) if M[r][col]), None)
        if piv is None:
            raise ValueError("singular GF matrix")
        M[col], M[piv] = M[piv], M[col]
        inv = gf_inv_int(M[col][col])
        M[col] = [gf_mul_int(v, inv) for v in M[col]]
        for r in range(n):
            if r != col and M[r][col]:
                f = M[r][col]
                M[r] = [vr ^ gf_mul_int(f, vc)
                        for vr, vc in zip(M[r], M[col])]
    return [row[n:w] for row in M]


@functools.lru_cache(maxsize=None)
def rs_generator_rows(k: int, r: int) -> tuple[tuple[int, ...], ...]:
    """Systematic RS parity rows: parity_j = sum_i V[j][i] * data_i with
    V[j][i] = (2^j)^i (Vandermonde on the distinct points 1, 2, 4, ...)."""
    return tuple(tuple(gf_pow_int(gf_pow_int(2, j), i) for i in range(k))
                 for j in range(r))


@functools.lru_cache(maxsize=None)
def rs_decode_matrix(k: int, r: int, missing: tuple[int, ...],
                     parity_avail: tuple[int, ...]
                     ) -> tuple[tuple[int, ...], ...]:
    """Coefficients reconstructing `missing` data rows from the survivors.

    Survivor order: [data rows not in `missing`, ascending] + [parity rows
    in `parity_avail`, ascending].  Returns an (m x n_survivors) matrix C
    with data_missing = C @ survivors over GF(256); () when nothing is
    missing.
    """
    missing = tuple(sorted(missing))
    parity_avail = tuple(sorted(parity_avail))
    m = len(missing)
    if m == 0:
        return ()
    if m > len(parity_avail):
        raise ValueError("unrecoverable: more erasures than available parity")
    V = rs_generator_rows(k, r)
    use_par = parity_avail[:m]
    present = [i for i in range(k) if i not in missing]
    # A x = b: A[j][t] = V[p_j][missing_t]; b_j = parity_j ^ sum_present ...
    A = [[V[p][t] for t in missing] for p in use_par]
    n_sur = len(present) + len(parity_avail)
    B = []
    for p in use_par:
        row = [0] * n_sur
        for c, i in enumerate(present):
            row[c] = V[p][i]                       # move to RHS (XOR = add)
        row[len(present) + parity_avail.index(p)] = 1
        B.append(row)
    return tuple(tuple(row) for row in gf_solve(A, B))
