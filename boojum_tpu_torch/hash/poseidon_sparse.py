"""The classic Poseidon permutation with sparse partial rounds: the
constants of the tree kernels' round order (``csrc/poseidon.cu``
`permute_regs`), derived in exact Python ints mod p from the port's own
round constants and MDS (the Poseidon paper's appendix B; Plonky2's
``mds_partial_layer_fast``).

The 22 partial rounds of `poseidon.s_permutation` are
``x <- M · S0(x + c_r)``, S0 the s-box on element 0 only. Two rewrites
leave the permutation unchanged:

- **Constants forward.** The part of ``c_r`` on elements 1..11 passes S0
  untouched, so ``M`` carries it into round r + 1's constants. Each partial
  round then adds the scalar ``k_r`` to element 0 only, and what is left
  after the last one, ``residual``, joins the constants of full round 26.
- **Sparse matrices backward.** Round r's matrix ``M_r`` (``M_21 = M``)
  splits as ``B_r · A_r`` with ``A_r = diag(1, N_r)``, ``N_r`` its 11 x 11
  block, and ``B_r`` the identity but for row 0 (``M_r[0][0]`` = 1 and
  ``ŵ_r = M_r[0][1:] · N_r^-1``) and column 0 (``v_r = M_r[1:][0]``).
  ``A_r`` commutes with round r's s-box and constant, so it moves into
  round r - 1: ``M_{r-1} = A_r · M``. ``N_r = N^(22 - r)`` stays invertible
  down to round 0, whose ``A_0`` runs once, dense, before the partial
  rounds.

A partial round is then: ``y = sbox(x0 + k_r)``;
``x0 <- y + Σ_i ŵ_r[i] x_i``; ``x_i <- x_i + v_r[i] y`` (i = 1..11): 22
general products in place of a dense 12 x 12 product.
"""

from __future__ import annotations

import functools

from ..field.goldilocks import ORDER
from . import _poseidon_constants as C

P = ORDER
WIDTH = C.STATE_WIDTH
HALF_FULL = C.HALF_NUM_FULL_ROUNDS
PARTIAL = C.NUM_PARTIAL_ROUNDS
# the kernel's table (`poseidon_tree_set_constants`): the 8 full rounds'
# constants (the first of the second half with the residual), A_0 by rows,
# then each partial round's k, ŵ (11) and v (11)
FULL_SIZE = 2 * HALF_FULL * WIDTH
A0_SIZE = (WIDTH - 1) ** 2
PARTIAL_STRIDE = 2 * WIDTH - 1
TABLE_SIZE = FULL_SIZE + A0_SIZE + PARTIAL * PARTIAL_STRIDE


def mds() -> list:
    """The circulant MDS, MDS[r][c] = 2^EXPS[(12 - r + c) % 12]."""
    e = C.MDS_MATRIX_EXPS
    return [[1 << e[(WIDTH - r + c) % WIDTH] for c in range(WIDTH)]
            for r in range(WIDTH)]


def _matvec(a, v):
    return [sum(x * y for x, y in zip(row, v)) % P for row in a]


def _inverse(a):
    """The inverse mod p of a square matrix (Gauss-Jordan)."""
    n = len(a)
    aug = [list(row) + [int(i == j) for j in range(n)]
           for i, row in enumerate(a)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col])
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], P - 2, P)
        aug[col] = [x * inv % P for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(x - f * y) % P for x, y in zip(aug[r], aug[col])]
    return [row[n:] for row in aug]


@functools.lru_cache(maxsize=None)
def constants() -> dict:
    """The sparse form's constants, canonical ints: ``full`` (8 rounds x
    12: rounds 0..3, then 26..29 with the residual added to round 26),
    ``a0`` (11 x 11), ``k`` (22), ``w_hat`` and ``v`` (22 x 11), and
    ``residual`` (12)."""
    rc = C.ALL_ROUND_CONSTANTS
    m = mds()
    # constants forward
    carry = [0] * WIDTH
    k = []
    for r in range(PARTIAL):
        base = (HALF_FULL + r) * WIDTH
        eff = [(c + d) % P for c, d in zip(rc[base:base + WIDTH], carry)]
        k.append(eff[0])
        carry = _matvec(m, [0] + eff[1:])
    residual = carry
    # sparse matrices backward; every M_r keeps M's row 0, whose first
    # entry (B_r's, the kernel's implied factor of y) is 2^0 = 1
    w_m = m[0][1:]
    w_hat, v = [None] * PARTIAL, [None] * PARTIAL
    mr = m
    for r in reversed(range(PARTIAL)):
        nr = [row[1:] for row in mr[1:]]
        w_hat[r] = _matvec([list(col) for col in zip(*_inverse(nr))], w_m)
        v[r] = [row[0] for row in mr[1:]]
        # M_{r-1} = A_r · M, A_r = diag(1, N_r)
        mr = [m[0]] + [[sum(nr[i][j] * m[1 + j][c] for j in range(WIDTH - 1))
                        % P for c in range(WIDTH)] for i in range(WIDTH - 1)]
    a0 = nr  # N_0
    full = [list(rc[r * WIDTH:(r + 1) * WIDTH]) for r in range(HALF_FULL)]
    second = (HALF_FULL + PARTIAL) * WIDTH
    full += [list(rc[second + r * WIDTH:second + (r + 1) * WIDTH])
             for r in range(HALF_FULL)]
    full[HALF_FULL] = [(c + d) % P for c, d in zip(full[HALF_FULL], residual)]
    return dict(full=full, a0=a0, k=k, w_hat=w_hat, v=v, residual=residual)


def kernel_table() -> list:
    """The constants as the kernel's flat u64 table (`TABLE_SIZE`)."""
    c = constants()
    out = [x for row in c["full"] for x in row]
    out += [x for row in c["a0"] for x in row]
    for r in range(PARTIAL):
        out += [c["k"][r]] + c["w_hat"][r] + c["v"][r]
    assert len(out) == TABLE_SIZE
    return out


def _sbox(x):
    return pow(x, 7, P)


def s_permutation(state: list) -> list:
    """The permutation in the sparse form, exact ints: equal to
    `poseidon.s_permutation`."""
    c = constants()
    m = mds()
    s = [x % P for x in state]

    def full_round(s, consts):
        return _matvec(m, [_sbox((x + y) % P) for x, y in zip(s, consts)])

    for r in range(HALF_FULL):
        s = full_round(s, c["full"][r])
    s = [s[0]] + _matvec(c["a0"], s[1:])
    for r in range(PARTIAL):
        y = _sbox((s[0] + c["k"][r]) % P)
        s0 = (y + sum(w * x for w, x in zip(c["w_hat"][r], s[1:]))) % P
        s = [s0] + [(x + vi * y) % P for x, vi in zip(s[1:], c["v"][r])]
    for r in range(HALF_FULL, 2 * HALF_FULL):
        s = full_round(s, c["full"][r])
    return s
