# Port of boojum_tpu/prover/device_prover.py:1704 `_stage23_jit` (the reference's one program for stages 2 and 3).
"""Stages 2 and 3 of a prove on the base domain: the copy-permutation grand
product z, its partial products and the lookup A / B polys, as one
(n, 2·k2) int64 stage-2 Lagrange matrix.

Column order (the reference's `device_prover.py:1828-1831`): z, the G - 1
partial products, the A poly of each lookup repetition, then B, each as its
c0 column then its c1 column. With G = ceil(num_var / qd) chunks of qd copy
columns, chunk c's ratio on row i is

    r_c = prod_j (w_j + β·k_j·x + γ) / prod_j (w_j + β·σ_j + γ),

z[i] = prod_{k<i} prod_c r_c[k] (exclusive, z[0] = 1) and partial c is
z·r_0···r_c for c < G - 1. The lookup aggregates are β_l + Σ γ^i·col_i
(+ γ^width·id, the table id in a constant column); A = 1/agg (times the
marker's selector ``sel`` in the general-purpose modes), B = m/agg_t over
the table columns and the multiplicity m. A zero aggregate inverts to 0
(so a bad lookup shows in the quotient's top-coefficient check).

`stage23` launches two Hopper kernels on CUDA tensors
(``csrc/stage23.cu``), one launch each: ``stage23_rows`` (a few lanes a
row, the row staged in shared memory: every chunk's products and ratio,
their total, every aggregate, one masked batch inversion of all the row's
norms by one Fermat chain (`inverse_chain`: 63 squarings and 9
multiplies), the A and B columns written straight into the output, the
ratios and the total into the z and partial columns as scratch) and
``stage23_scan`` (the exclusive GL2 prefix product of the totals and the
partials over the scratch, in one single-pass launch: tiles of
`SCAN_TILE` rows by atomic ticket with decoupled look-back, its status
words `scan_status`). A zero maps to zero element by element, as the
reference's inverse maps it. On CPU tensors it runs `stage23_plain`:
`stage23_ops`, the port's op-by-op body of the two stages, which the
sharded prove runs with the distributed grand product.
"""

from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ..field import extension as ext2
from ..field import goldilocks as gl
from . import device as dops
from .jit_ops import EV, affine

# launches of each kernel entry ("stage23_rows", "stage23_scan"), and calls
# of the plain version on a CUDA tensor (chip_smoke.py reads them around
# each path)
LAUNCHES = collections.Counter()
PLAIN_CUDA_CALLS = 0
# launches by shape: ("rows",) + the row kernel's first 15 parameters
# (`row_params`) + (a selector or not,), and ("scan", n, G)
SHAPES = collections.Counter()
# rows a tile of the scan (csrc/stage23.cu SCAN_TILE)
SCAN_TILE = 512
# table-id columns the row kernel takes (csrc/stage23.cu MAX_TID)
MAX_TID = 64
# inverses a row the row kernel takes: 32 lanes of 16 slots
# (csrc/stage23.cu ROUNDS_LARGE)
MAX_INVERSES = 512
# the scan's status words: the ticket counter's head, then words a tile
# (csrc/stage23.cu STATUS_HEAD, STATUS_WORDS)
STATUS_HEAD, STATUS_WORDS = 8, 8
# (device, stream) -> the scan's zeroed status words there (`scan_status`)
_STATUS = {}
# the scans' epochs: each call takes a new one (`scan_status`)
_EPOCHS = itertools.count(1)


@dataclass(frozen=True)
class LookupInputs:
    """The lookup argument's inputs of stage 3. ``beta`` and the ``gamma_pows``
    [γ^0 .. γ^width] are ext scalars (host pairs, or `ext2.PreparedExt` on
    the device); the columns are indices: ``pw`` witness columns a
    repetition from ``base_off``, the table ids in setup columns
    ``tid_cols`` (one shared, or one a repetition; empty when the id is not
    in a constant column), ``num_table`` table columns from setup column
    ``table_off``, the multiplicity in witness column ``mult_col``; ``sel``
    the marker's selector (n,) in the general-purpose modes, else None."""

    beta: object
    gamma_pows: list
    width: int
    pw: int
    base_off: int
    num_subargs: int
    tid_cols: tuple
    table_off: int
    num_table: int
    mult_col: int
    sel: torch.Tensor = None


@dataclass(frozen=True)
class NonResidues:
    """The copy permutation's num_var non-residues k_j in both forms the
    stages take: ``ints`` (Python ints, the plain version's scalars) and
    ``tensor`` (num_var,) on the kernels' device. A prover makes it once."""

    ints: tuple
    tensor: torch.Tensor

    @classmethod
    def make(cls, ints, device) -> "NonResidues":
        ints = tuple(int(v) for v in ints)
        return cls(ints, dops.upload(np.asarray(ints, np.uint64), device))

    def __len__(self):
        return len(self.ints)


def num_columns(num_var: int, qd: int, lookup: LookupInputs = None) -> int:
    """Columns of the stage-2 matrix: 2·(z, G - 1 partials, A's, B)."""
    polys = -(-num_var // qd)
    if lookup is not None:
        polys += lookup.num_subargs + 1
    return 2 * polys


def aggregate(lookup: LookupInputs, cols, tid_col, size: int, device) -> EV:
    """β_l + Σ γ^i·cols[i] (+ γ^width·tid_col) over ``size`` rows (the
    quotient's lookup terms take it too)."""
    agg = EV.const(lookup.beta, (size,), device)
    for i, col in enumerate(cols):
        agg = agg + EV(*ext2.base_scale(col, lookup.gamma_pows[i]))
    if tid_col is not None:
        agg = agg + EV(*ext2.base_scale(tid_col,
                                        lookup.gamma_pows[lookup.width]))
    return agg


def stage23_plain(wit: torch.Tensor, setup: torch.Tensor, x_vals, non_res,
                  beta, gamma, qd: int, lookup: LookupInputs = None):
    """The kernels' plain version: `stage23_ops` with the single-device
    grand product."""
    _count_plain(wit)
    return stage23_ops(wit, setup, x_vals, non_res, beta, gamma, qd, lookup,
                       dops.grand_product_exclusive)


def stage23_ops(wit: torch.Tensor, setup: torch.Tensor, x_vals, non_res,
                beta, gamma, qd: int, lookup: LookupInputs, grand_product):
    """Stages 2 and 3 op by op on whole columns. ``wit`` (rows, k) and
    ``setup`` (rows, k') are the witness and setup oracles' Lagrange
    values (variables first in both: sigma in the setup); ``non_res`` the
    num_var non-residues k_j (`NonResidues`); ``grand_product`` the exclusive
    prefix product of the ratios (for a sharded prove the distributed one,
    which no kernel replaces: the reference's mesh path runs these ops
    too, boojum_tpu/prover/device_prover.py:852-908)."""
    rows, dev = wit.shape[0], wit.device
    non_res = non_res.ints
    num_var = len(non_res)
    var_base = wit.T
    sigma_base = setup.T[:num_var]

    chunk_ratios = []
    for start in range(0, num_var, qd):
        num = EV.const((1, 0), (rows,), dev)
        den = EV.const((1, 0), (rows,), dev)
        for j in range(start, min(start + qd, num_var)):
            w = var_base[j]
            num = num * EV(*affine(w, gl.mul(x_vals, non_res[j]), beta, gamma))
            den = den * EV(*affine(w, sigma_base[j], beta, gamma))
        chunk_ratios.append(num * den.inv())
    ratio = chunk_ratios[0]
    for r in chunk_ratios[1:]:
        ratio = ratio * r
    z_vals = EV(*grand_product(ratio.a))
    intermediates = []
    prev = z_vals
    for r in chunk_ratios[:-1]:
        prev = prev * r
        intermediates.append(prev)

    # Specialized modes: A_i = 1/agg_i on every row. General-purpose
    # modes: A_i = sel/agg_i, sel the marker gate's selector, so A_i is
    # 0 off the marker rows. A zero agg_i (inverted to 0, as the
    # reference's batch inverse does) on a row that looks up leaves
    # A·agg - sel = -1 there: the quotient is then not divisible, which
    # the top-coefficient check (runtime_asserts) reports.
    lookup_a_polys, lookup_b_polys = [], []
    if lookup is not None:
        lk = lookup
        setup_base = setup.T
        for rep in range(lk.num_subargs):
            cols = [var_base[lk.base_off + rep * lk.pw + i]
                    for i in range(lk.pw)]
            tid = setup_base[lk.tid_cols[min(rep, len(lk.tid_cols) - 1)]] \
                if lk.tid_cols else None
            a_poly = aggregate(lk, cols, tid, rows, dev).inv()
            if lk.sel is not None:
                a_poly = a_poly.mul_base(lk.sel)
            lookup_a_polys.append(a_poly)
        table_base = setup_base[lk.table_off:lk.table_off + lk.num_table]
        agg_t = aggregate(lk, list(table_base), None, rows, dev)
        lookup_b_polys.append(agg_t.inv().mul_base(var_base[lk.mult_col]))

    stage2_polys = [z_vals] + intermediates + lookup_a_polys + lookup_b_polys
    return torch.stack([c for p in stage2_polys for c in p.a], dim=1)


def _count_plain(t: torch.Tensor):
    global PLAIN_CUDA_CALLS
    if t.is_cuda:
        PLAIN_CUDA_CALLS += 1


def _check(t, what: str, rows: int, dim: int):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 \
            or t.dim() != dim or t.shape[0] != rows:
        raise TypeError("stage23 wants %s as a %d-D int64 tensor of %d rows, "
                        "got %s" % (what, dim, rows, getattr(
                            t, "shape", type(t).__name__)))


def _scalars(values, device) -> torch.Tensor:
    """The ext scalars ``values`` as one int64 tensor [c0, c1, c0, c1, ...]
    on ``device``: host pairs through a pinned upload, device scalars
    (`ext2.PreparedExt`) by one stack; neither waits for the device."""
    comps = [c for v in values for c in (v[0], v[1])]
    if all(isinstance(c, (int, np.integer)) for c in comps):
        return dops.upload(np.asarray([int(c) % gl.ORDER for c in comps],
                                      np.uint64), device)
    return torch.stack([c.value if isinstance(c, gl.Prepared) else c
                        for c in comps]).to(device)


def row_params(n: int, num_var: int, qd: int, ldw: int, lds: int,
               lookup: LookupInputs, wit_cols: int, setup_cols: int) -> list:
    """The row kernel's integer parameters (csrc/stage23.cu `RowParams`,
    in its field order); the lookup's columns are checked against the
    witness's and setup's column counts."""
    lk = lookup
    tids = list(lk.tid_cols) if lk is not None else []
    if len(tids) > MAX_TID:
        raise ValueError("stage23 takes at most %d table-id columns, got %d"
                         % (MAX_TID, len(tids)))
    if lk is not None and not (
            lk.base_off + lk.num_subargs * lk.pw <= wit_cols
            and 0 <= lk.mult_col < wit_cols
            and lk.table_off + lk.num_table <= setup_cols
            and all(0 <= t < setup_cols for t in tids)):
        raise ValueError("a lookup column lies outside the witness (%d "
                         "columns) or the setup (%d)" % (wit_cols, setup_cols))
    head = [n, num_var, qd, ldw, lds, num_columns(num_var, qd, lk)]
    if lk is None:
        head += [0] * 9
    else:
        head += [1, lk.num_subargs, lk.pw, lk.base_off, lk.width, len(tids),
                 lk.table_off, lk.num_table, lk.mult_col]
    return head + tids + [0] * (MAX_TID - len(tids))


def stage23(wit: torch.Tensor, setup: torch.Tensor, x_vals: torch.Tensor,
            non_res: NonResidues, beta, gamma, qd: int,
            lookup: LookupInputs = None) -> torch.Tensor:
    """The (n, 2·k2) stage-2 Lagrange matrix of ``wit`` (n, k) and ``setup``
    (n, k') (row-major, any row stride), ``x_vals`` (n,) = ω^i, the
    num_var non-residues ``non_res`` and the challenges β,
    γ (host pairs or device `ext2.PreparedExt`). On CUDA tensors: one
    ``stage23_rows`` launch and one ``stage23_scan`` launch, no
    synchronization; on CPU tensors `stage23_plain`."""
    n = wit.shape[0]
    _check(wit, "the witness", n, 2)
    _check(setup, "the setup", n, 2)
    _check(x_vals, "x", n, 1)
    num_var = len(non_res)
    if num_var < 1 or qd < 1 or wit.shape[1] < num_var \
            or setup.shape[1] < num_var:
        raise ValueError("stage23 needs 1 <= num_var <= the columns, got "
                         "num_var %d, qd %d, shapes %s %s" % (
                             num_var, qd, tuple(wit.shape),
                             tuple(setup.shape)))
    if wit.device.type == "cpu":
        return stage23_plain(wit, setup, x_vals, non_res, beta, gamma, qd,
                             lookup)
    if wit.device.type != "cuda" or setup.device != wit.device \
            or x_vals.device != wit.device:
        raise RuntimeError("stage23 has no kernel for devices %s, %s, %s"
                           % (wit.device, setup.device, x_vals.device))
    launch = Launch(wit, setup, x_vals, non_res, beta, gamma, qd, lookup)
    launch.rows()
    launch.scan()
    return launch.out


class Launch:
    """One `stage23` call on CUDA tensors, its arguments prepared: `rows`
    and `scan` launch the two kernels into ``out`` (n, 2·k2), each counted
    (`chip_smoke.py` also times each alone); ``prods`` are the scan's
    status words (`scan_status`)."""

    def __init__(self, wit, setup, x_vals, non_res: NonResidues, beta,
                 gamma, qd: int, lookup: LookupInputs = None):
        from ..utils import cuda_build

        n, dev = wit.shape[0], wit.device
        if wit.stride(1) != 1:
            wit = wit.contiguous()
        if setup.stride(1) != 1:
            setup = setup.contiguous()
        non_res_dev = non_res.tensor
        if non_res_dev.shape != (len(non_res),) or non_res_dev.device != dev:
            raise ValueError("stage23 wants the %d non-residues on %s, got %s "
                             "on %s" % (len(non_res), dev,
                                        tuple(non_res_dev.shape),
                                        non_res_dev.device))
        sel = None
        scal = [beta, gamma]
        if lookup is not None:
            if len(lookup.gamma_pows) < max(lookup.width + 1,
                                            lookup.num_table):
                raise ValueError("stage23 needs gamma powers up to the "
                                 "table width")
            scal += [lookup.beta] + list(lookup.gamma_pows)
            if lookup.sel is not None:
                _check(lookup.sel, "sel", n, 1)
                sel = lookup.sel.contiguous()
        params = row_params(n, len(non_res), qd, wit.stride(0),
                            setup.stride(0), lookup, wit.shape[1],
                            setup.shape[1])
        if params[5] // 2 > MAX_INVERSES:
            raise ValueError("stage23's row kernel takes at most %d inverses "
                             "a row, got %d" % (MAX_INVERSES, params[5] // 2))
        # the tensors the launches read, kept alive with the launch
        self.inputs = (wit, setup, x_vals.contiguous(), non_res_dev,
                       _scalars(scal, dev), sel)
        self.params = np.asarray(params, np.int64)
        self.key = ("rows",) + tuple(params[:15]) + (sel is not None,)
        self.n, self.chunks = n, -(-len(non_res) // qd)
        self.out = wit.new_empty((n, params[5]))
        self.lib = cuda_build.load("stage23")
        self.stream = cuda_build.stream_handle(wit)
        self.prods = scan_status(dev, self.stream, n)

    def rows(self):
        from ..utils import cuda_build

        cuda_build.check(self.lib.stage23_rows(
            *(None if t is None else t.data_ptr() for t in self.inputs),
            self.out.data_ptr(), self.params.ctypes.data, self.stream),
            "stage23_rows")
        LAUNCHES["stage23_rows"] += 1
        SHAPES[self.key] += 1

    def scan(self):
        from ..utils import cuda_build

        cuda_build.check(self.lib.stage23_scan(
            self.out.data_ptr(), self.prods.data_ptr(), self.n, self.chunks,
            self.out.shape[1], new_epoch(), self.stream), "stage23_scan")
        LAUNCHES["stage23_scan"] += scan_launches(self.n)
        SHAPES[("scan", self.n, self.chunks)] += 1


def scan_launches(n: int) -> int:
    """Kernel launches of one `stage23_scan` call over n rows."""
    return 1


def scan_status(device, stream: int, n: int) -> torch.Tensor:
    """The scan's status words for n rows on ``stream`` of ``device``: the
    ticket counter, then a flag, the aggregate and the inclusive prefix a
    tile (csrc/stage23.cu). They are zeroed once, when a stream first needs
    this many tiles; the kernel leaves the counter at 0 and tags each flag
    with its call's epoch (`new_epoch`), so no call clears them and calls on
    one stream reuse them."""
    key = (torch.device(device), stream)
    words = STATUS_HEAD + STATUS_WORDS * -(-n // SCAN_TILE)
    status = _STATUS.get(key)
    if status is None or status.numel() < words:
        grown = max(words, 2 * status.numel() if status is not None else 0)
        status = _STATUS[key] = torch.zeros(grown, dtype=torch.int64,
                                            device=device)
    return status


def new_epoch() -> int:
    """A scan epoch above every earlier one (csrc/stage23.cu: a status flag
    is epoch << 2 | state)."""
    return next(_EPOCHS)


# ---------------------------------------------------------------------------
# Random inputs with zero rows, for the checks of the plain version and the
# kernels (the CPU tests, the card's tests and chip_smoke.py)
# ---------------------------------------------------------------------------


def random_inputs(rng, n: int, num_var: int, qd: int, wit_cols: int,
                  setup_cols: int, lookup: dict = None,
                  zero_rows: tuple = None, zero_slots: dict = None) -> dict:
    """Random canonical host inputs of `stage23` from the numpy generator
    ``rng``: witness (n, wit_cols), setup (n, setup_cols), x, the num_var
    non-residues and β, γ; with ``lookup`` (`LookupInputs`' column fields
    and ``sel``: True for the general-purpose modes' selector, zero on
    every third row) the lookup β_l and γ^0 .. γ^max(width, num_table - 1)
    too. ``zero_rows`` (a, b, den) makes repetition 0's aggregate zero on
    row a and the table aggregate on row b (with lookups), and copy column
    0's denominator on row den (z is zero after it). ``zero_slots`` maps a
    row to the inverses (slots, as the row kernel numbers them) made zero
    there: slot k < G chunk k's denominator (through one of its columns
    that no repetition's first two columns take), G + r repetition r's
    aggregate, G + num_subargs the table's. Returns the keyword arguments
    of `stage23` as numpy arrays and Python ints (``lookup`` a dict,
    ``non_res`` a list)."""
    P = gl.ORDER

    def draw(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    def pair():
        return tuple(int(v) for v in draw(2))

    wit, setup = draw(n, wit_cols), draw(n, setup_cols)
    x, non_res = draw(n), [int(v) for v in draw(num_var)]
    beta, gamma = pair(), pair()
    lk = None
    if lookup is not None:
        lbeta, lgamma = pair(), pair()
        pows = [(1, 0)]
        for _ in range(max(lookup["width"], lookup["num_table"] - 1)):
            pows.append(ext2.s2_mul(pows[-1], lgamma))
        sel = None
        if lookup.get("sel"):
            sel = draw(n)
            sel[::3] = 0  # off the marker's rows
        lk = dict(lookup, beta=lbeta, gamma_pows=pows, sel=sel)
    sig = (-gamma[1]) * pow(beta[1], P - 2, P) % P

    def zero_den(row, col):
        # w + β·σ + γ = 0 in both components
        setup[row, col] = sig
        wit[row, col] = (-(beta[0] * sig + gamma[0])) % P

    def solve(row, cols, extra):
        # cols[0] meets γ^0 = (1, 0), cols[1] γ^1: chosen so that
        # β_l + Σ γ^t·row[cols[t]] + extra = 0 in both components
        g = lk["gamma_pows"]
        s0 = (lbeta[0] + extra[0]) % P
        s1 = (lbeta[1] + extra[1]) % P
        for t, c in enumerate(cols[2:], start=2):
            s0 = (s0 + int(row[c]) * g[t][0]) % P
            s1 = (s1 + int(row[c]) * g[t][1]) % P
        row[cols[1]] = (-s1) * pow(g[1][1], P - 2, P) % P
        row[cols[0]] = (-(s0 + int(row[cols[1]]) * g[1][0])) % P

    def zero_lookup(row, rep):
        tids = lk["tid_cols"]
        tid = int(setup[row, tids[min(rep, len(tids) - 1)]]) if tids else 0
        g, w = lk["gamma_pows"], lk["width"]
        solve(wit[row], [lk["base_off"] + rep * lk["pw"] + t
                         for t in range(lk["pw"])],
              (tid * g[w][0] % P, tid * g[w][1] % P))

    def zero_table(row):
        solve(setup[row], [lk["table_off"] + t
                           for t in range(lk["num_table"])], (0, 0))

    if zero_rows is not None:
        a, b, den = zero_rows
        if lk is not None:
            zero_lookup(a, 0)
            zero_table(b)
        zero_den(den, 0)
    chunks = -(-num_var // qd)
    solved = set()
    if lk is not None:
        for rep in range(lk["num_subargs"]):
            first = lk["base_off"] + rep * lk["pw"]
            solved |= {first, first + 1}
    for row, slots in (zero_slots or {}).items():
        for k in sorted(slots):  # the denominators before the aggregates
            if k < chunks:
                free = [j for j in range(k * qd, min(k * qd + qd, num_var))
                        if j not in solved]
                if not free:
                    raise ValueError("chunk %d has no column free of the "
                                     "lookups' solved ones" % k)
                zero_den(row, free[0])
            elif lk is not None and k - chunks < lk["num_subargs"]:
                zero_lookup(row, k - chunks)
            elif lk is not None and k - chunks == lk["num_subargs"]:
                zero_table(row)
            else:
                raise ValueError("no slot %d in a row" % k)
    return dict(wit=wit, setup=setup, x_vals=x, non_res=non_res, beta=beta,
                gamma=gamma, qd=qd, lookup=lk)


def args_on(inputs: dict, device, device_scalars: bool = False) -> tuple:
    """`random_inputs`' values as `stage23`'s arguments on ``device``; with
    ``device_scalars`` the challenges as device `ext2.PreparedExt` (as a
    device-transcript prove hands them over), else host pairs."""
    beta, gamma, lk = inputs["beta"], inputs["gamma"], inputs["lookup"]

    def dev(pairs):
        return ext2.prepare(gl.from_u64(np.asarray(pairs, np.uint64), device))

    if device_scalars:
        beta, gamma = dev([beta, gamma])
    if lk is not None:
        lk = dict(lk, sel=None if lk["sel"] is None
                  else gl.from_u64(lk["sel"], device))
        if device_scalars:
            lk.update(beta=dev([lk["beta"]])[0],
                      gamma_pows=dev(lk["gamma_pows"]))
        lk = LookupInputs(**lk)
    return (gl.from_u64(inputs["wit"], device),
            gl.from_u64(inputs["setup"], device),
            gl.from_u64(inputs["x_vals"], device),
            NonResidues.make(inputs["non_res"], device), beta, gamma,
            inputs["qd"], lk)


# ---------------------------------------------------------------------------
# Exact twins of the kernels' arithmetic (Python ints), for the emulation
# ---------------------------------------------------------------------------

# p - 2 = 0b(31 ones) 0 (32 ones): the kernels' addition chain, as
# (squarings, multiplicand) steps over the named powers x^(2^k - 1)
INVERSE_CHAIN = (
    ("t2", "x", 1, "x"), ("t3", "t2", 1, "x"), ("t6", "t3", 3, "t3"),
    ("t12", "t6", 6, "t6"), ("t24", "t12", 12, "t12"),
    ("t30", "t24", 6, "t6"), ("t31", "t30", 1, "x"),
    ("t63", "t31", 32, "t31"), ("t64", "t63", 1, "x"))


def inverse_chain(x: int) -> int:
    """x^(p-2) mod p by `INVERSE_CHAIN` (0 maps to 0): each step squares
    its base k times and multiplies by the named power."""
    p = gl.ORDER
    named = {"x": x % p}
    for out, base, k, by in INVERSE_CHAIN:
        v = named[base]
        for _ in range(k):
            v = v * v % p
        named[out] = v * named[by] % p
    return named["t64"]
