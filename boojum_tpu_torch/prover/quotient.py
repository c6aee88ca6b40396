# Port of boojum_tpu/prover/device_prover.py:165 `_quotient_full_fn` (its sweep: `_lookup_quotient_body` :1844, `_gate_sweep_body` :1621, `_copyperm_quotient_body` :1931 and the vanishing division).
"""The quotient sweep of a prove: every term of the quotient over the flat
(qd·n) domain, α-weighted and summed, divided by the vanishing poly, as the
(qd·n, 2) int64 array the coset iNTT takes.

The terms, in the alphas' order (`QuotientInputs`):

- lookups: per repetition A·agg - 1 (the specialized modes) or A·agg - sel
  (the general-purpose ones, sel the marker's selector over the flat
  domain), agg = β_l + Σ γ^i·col_i (+ γ^width·id, the table id in a
  constant column); then B·agg_t - m over the table columns and the
  multiplicity;
- every specialized gate's terms (on every row), then every general gate's
  terms times its selector-path product (`cs/gates/tape.py` `GateSweep`);
- the copy permutation: the boundary (z - 1)·L1, then per chunk of qd copy
  columns lhs·Π(w + β·σ + γ) - rhs·Π(w + β·k_j·x + γ), the chunk's lhs the
  next partial product (the last chunk's z(ωx)) and its rhs the one before
  (the first chunk's z).

On CUDA tensors `quotient_sweep` makes one launch of the Hopper kernel
``quotient_sweep`` (``csrc/quotient.cu``): one thread a point, the lookup
and copy-permutation terms as fixed code, the gate terms by interpreting
the circuit's recorded tape (`cs/gates/tape.py`), the sum times the
coset's 1/Z_H; the challenges in one scalar buffer (`scalar_buffer`), α
alone: the kernel weighs the terms, in order, by a running power of α.
On CPU tensors it runs `quotient_plain`, the port's op-by-op sweep (the
gate evaluators under `TorchOps`). A
sharded prove calls `quotient_sweep` on each rank's coset-major blocks of
the flat domain (qd·n/S points, S ranks): every term is pointwise, so
nothing crosses ranks.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch

from ..cs.gates import tape as tape_mod
from ..cs.gates.base import TorchOps
from ..field import extension as ext2
from ..field import goldilocks as gl
from . import device as dops
from .device_transcript import ext_pow_list
from .jit_ops import EV, affine
from .stage23 import LookupInputs, NonResidues, _scalars, aggregate

# launches of the kernel, and calls of the plain version on a CUDA tensor
# (chip_smoke.py reads them around each path)
LAUNCHES = collections.Counter()
PLAIN_CUDA_CALLS = 0
# launches by key: (the `QuotientInputs`, rows a coset, witness, setup and
# stage-2 columns, LDE factor of the oracles)
SHAPES = collections.Counter()
# the kernel's sizes (csrc/quotient.cu): threads a block, tape instructions
# staged in shared memory at a time, table-id columns; the shared memory a
# block may take on an H100 (the tape's slots, β·k_j, the staged chunk)
THREADS = 128
CHUNK = 512
MAX_TID = 64
MAX_SHARED = 232448


@dataclass(frozen=True, eq=False)
class QuotientInputs:
    """The quotient's layout, the same from prove to prove: ``qd`` cosets,
    ``num_var`` copy columns (the first witness and setup columns), the
    stage-2 columns (z, ``num_inter`` partials, with lookups A per
    repetition and B, each two columns); with ``lookup`` its repetitions'
    columns (`stage23.LookupInputs`' fields: ``pw`` witness columns a
    repetition from ``base_off``, the table ids in setup columns
    ``tid_cols``, ``num_table`` table columns from setup column
    ``table_off``, the multiplicity in witness column ``mult_col``) and
    whether A·agg meets 1 (``specialized``) or the selector; the gates
    (`tape.GateSweep`) and their recorded ``tape``. Alphas: the
    ``lookup_terms`` (repetitions, then B), the gates' ``gate_terms``, then
    the boundary and one a chunk."""

    qd: int
    num_var: int
    lookup: bool
    specialized: bool
    num_subargs: int
    width: int
    pw: int
    base_off: int
    tid_cols: tuple
    table_off: int
    num_table: int
    mult_col: int
    gates: tuple
    tape: object

    @property
    def num_inter(self) -> int:
        return -(-self.num_var // self.qd) - 1

    @property
    def a_off(self) -> int:
        return 2 * (1 + self.num_inter)

    @property
    def b_off(self) -> int:
        return self.a_off + 2 * self.num_subargs

    @property
    def stage2_cols(self) -> int:
        return self.b_off + 2 if self.lookup else self.a_off

    @property
    def lookup_terms(self) -> int:
        return self.num_subargs + 1 if self.lookup else 0

    @property
    def gate_terms(self) -> int:
        return sum(g.num_terms for g in self.gates)

    @property
    def rem_alpha(self) -> int:
        return self.lookup_terms + self.gate_terms

    @property
    def num_alphas(self) -> int:
        return self.rem_alpha + 2 + self.num_inter

    @classmethod
    def of_circuit(cls, cs, setup_base) -> "QuotientInputs":
        """The layout and tape of a circuit and its base setup."""
        geometry = cs.geometry
        lp = cs.lookup_parameters
        num_var = setup_base.copy_permutation_polys.shape[0]
        num_const = setup_base.constant_columns.shape[0]
        sweeps, wit_cols, setup_cols = tape_mod.quotient_gates(cs,
                                                               setup_base)
        kw = dict(num_subargs=0, width=0, pw=0, base_off=0, tid_cols=(),
                  table_off=0, num_table=0, mult_col=0)
        if lp.lookup_is_allowed:
            kw = dict(
                num_subargs=lp.num_sublookup_arguments_for_geometry(geometry),
                width=lp.lookup_width(),
                pw=lp.specialized_columns_per_repetition()
                if lp.is_specialized else lp.columns_per_subargument(),
                base_off=geometry.num_columns_under_copy_permutation
                if lp.is_specialized else 0,
                tid_cols=tuple(num_var + t
                               for t in setup_base.table_ids_column_idxes)
                if lp.id_in_constant else (),
                table_off=num_var + num_const,
                num_table=setup_base.lookup_tables_columns.shape[0],
                mult_col=num_var + geometry.num_witness_columns)
        return cls(qd=setup_base.quotient_degree, num_var=num_var,
                   lookup=lp.lookup_is_allowed,
                   specialized=lp.is_specialized, gates=tuple(sweeps),
                   tape=tape_mod.record_tape(sweeps, wit_cols, setup_cols),
                   **kw)


@dataclass(frozen=True)
class Challenges:
    """The quotient's challenges: β, γ of the copy permutation, the
    lookup's β_l and [γ^0 ..] (None without lookups) and α, whose powers
    α^0 .. weigh the terms: host pairs or device `ext2.PreparedExt`."""

    beta: object
    gamma: object
    lookup_beta: object
    gamma_pows: list
    alpha: object


def selector_product(path, const_cols, size, dev):
    """The selector of a gate at ``path`` in the selector tree: the product
    over its constant columns of c (bit 1) or 1 - c (bit 0)."""
    prod = gl.full((size,), 1, dev)
    for k, bit in enumerate(path):
        col = const_cols[k]
        prod = gl.mul(prod, col if bit else gl.sub(gl.full((), 1, dev), col))
    return prod


def quotient_plain(q: QuotientInputs, wit, setup, stage2, x_lde, l1,
                   z_shift, vanish, non_res: NonResidues, ch: Challenges,
                   sel=None) -> torch.Tensor:
    """The kernel's plain version: the quotient's values op by op on whole
    columns, as (qd·rows, 2) (c0, c1) over the flat domain. ``wit``,
    ``setup`` and ``stage2`` are the oracles' transposed flat LDEs
    (k, L·rows), L >= qd (their first qd·rows points are read); ``x_lde``
    and ``l1`` (qd·rows,) X and the unnormalized L1 there, ``z_shift``
    (qd·rows, 2) z(ωX), ``vanish`` (qd,) 1/Z_H a coset, ``sel`` (qd·rows,)
    the marker's selector in the general-purpose lookup modes."""
    if wit.is_cuda:
        global PLAIN_CUDA_CALLS
        PLAIN_CUDA_CALLS += 1
    size, dev = x_lde.shape[0], x_lde.device
    ops = TorchOps(dev)
    alphas = ext_pow_list(ch.alpha, q.num_alphas)
    wcols = [wit[i, :size] for i in range(wit.shape[0])]
    scols = [setup[i, :size] for i in range(setup.shape[0])]
    st2 = [stage2[i, :size] for i in range(stage2.shape[0])]

    def ext_flat(i):
        return EV(st2[i], st2[i + 1])

    acc = EV.const((0, 0), (size,), dev)
    # lookup terms: A·agg - 1 (specialized) or A·agg - sel (general) per
    # subargument, B·agg_t - mult
    if q.lookup:
        lk = LookupInputs(beta=ch.lookup_beta, gamma_pows=ch.gamma_pows,
                          width=q.width, pw=q.pw, base_off=q.base_off,
                          num_subargs=q.num_subargs, tid_cols=q.tid_cols,
                          table_off=q.table_off, num_table=q.num_table,
                          mult_col=q.mult_col)
        one = 1 if q.specialized else sel
        for rep in range(q.num_subargs):
            cols = [wcols[q.base_off + rep * q.pw + i] for i in range(q.pw)]
            tid = scols[q.tid_cols[min(rep, len(q.tid_cols) - 1)]] \
                if q.tid_cols else None
            term = ext_flat(q.a_off + 2 * rep) * aggregate(lk, cols, tid,
                                                           size, dev)
            term = EV(gl.sub(term.c0, one), term.c1)
            acc = acc + term.scale(alphas[rep])
        table = scols[q.table_off:q.table_off + q.num_table]
        term = ext_flat(q.b_off) * aggregate(lk, table, None, size, dev)
        term = EV(gl.sub(term.c0, wcols[q.mult_col]), term.c1)
        acc = acc + term.scale(alphas[q.num_subargs])

    # gate terms: specialized gates on every row, general gates under their
    # selector-path products
    for g in q.gates:
        ev = g.evaluator
        gsel = None if g.path is None else selector_product(
            g.path, scols[g.sel_base:], size, dev)
        a = g.alpha
        for view in g.views(wcols, wcols, scols):
            for term in ev.evaluate(view, ops):
                term = term.expand(size)
                if gsel is not None:
                    term = gl.mul(term, gsel)
                acc = acc + EV(*ext2.base_scale(term, alphas[a]))
                a += 1

    # copy-permutation terms
    rem = q.rem_alpha
    z_flat = ext_flat(0)
    zm1 = EV(gl.sub(z_flat.c0, 1), z_flat.c1)
    acc = acc + zm1.mul_base(l1).scale(alphas[rem])
    z_shifted = EV(z_shift[:, 0], z_shift[:, 1])
    lhs_list = [ext_flat(2 + 2 * i) for i in range(q.num_inter)]
    lhs_list.append(z_shifted)
    rhs_list = [z_flat] + [ext_flat(2 + 2 * i) for i in range(q.num_inter)]
    for rel_idx, (lhs, rhs) in enumerate(zip(lhs_list, rhs_list)):
        for j in range(rel_idx * q.qd, min(rel_idx * q.qd + q.qd, q.num_var)):
            w = wcols[j]
            lhs = lhs * EV(*affine(w, scols[j], ch.beta, ch.gamma))
            rhs = rhs * EV(*affine(w, gl.mul(x_lde, non_res.ints[j]),
                                   ch.beta, ch.gamma))
        acc = acc + (lhs - rhs).scale(alphas[rem + 1 + rel_idx])
    # divide by the vanishing poly: 1/Z_H is one value a coset
    acc = acc.mul_base(vanish.repeat_interleave(size // q.qd))
    return torch.stack([acc.c0, acc.c1], dim=1)


def _check(t, what, shape):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 \
            or t.dim() != len(shape) or any(
                want is not None and got != want
                for got, want in zip(t.shape, shape)):
        raise TypeError("quotient_sweep wants %s as an int64 tensor of shape "
                        "%s, got %s" % (what, shape, getattr(
                            t, "shape", type(t).__name__)))


def quotient_sweep(q: QuotientInputs, wit, setup, stage2, x_lde, l1,
                   z_shift, vanish, non_res: NonResidues, ch: Challenges,
                   sel=None, program=None) -> torch.Tensor:
    """The (qd·n, 2) quotient values of `quotient_plain`'s arguments. On CUDA
    tensors one launch of the kernel ``quotient_sweep``, no
    synchronization (``program``: the tape on the device, `upload_tape`,
    uploaded here when None); on CPU tensors `quotient_plain`."""
    size = x_lde.shape[0]
    if size % q.qd:
        raise ValueError("quotient_sweep wants qd·n points, got %d for qd %d"
                         % (size, q.qd))
    _check(x_lde, "x", (size,))
    _check(l1, "L1", (size,))
    _check(z_shift, "z(ωx)", (size, 2))
    _check(vanish, "1/Z_H", (q.qd,))
    for t, what in ((wit, "the witness"), (setup, "the setup"),
                    (stage2, "the stage-2 oracle")):
        _check(t, what, (None, None))
        if t.shape[1] < size:
            raise ValueError("%s holds %d points, fewer than %d"
                             % (what, t.shape[1], size))
    if q.lookup and not q.specialized:
        _check(sel, "sel", (size,))
    if x_lde.device.type == "cpu":
        return quotient_plain(q, wit, setup, stage2, x_lde, l1, z_shift,
                              vanish, non_res, ch, sel)
    if x_lde.device.type != "cuda" or any(
            t is not None and t.device != x_lde.device
            for t in (wit, setup, stage2, l1, z_shift, vanish, sel)):
        raise RuntimeError("quotient_sweep has no kernel for these devices")
    launch = Launch(q, wit, setup, stage2, x_lde, l1, z_shift, vanish,
                    non_res, ch, sel, program)
    launch.run()
    return launch.out


def upload_tape(tape, device) -> tuple:
    """A tape's program (int32, its words two to an int64 for the upload,
    which then does not wait for the device) and constant pool (int64) on
    ``device``."""
    code = np.ascontiguousarray(tape.code).view(np.int64)
    return (dops.upload(code, device).view(torch.int32),
            dops.upload(tape.consts, device))


def params(q: QuotientInputs, rows: int, ldw: int, lds: int, ld2: int,
           wit_cols: int, setup_cols: int, st2_cols: int, ngpow: int) -> list:
    """The kernel's integer parameters (csrc/quotient.cu `Params`, in its
    field order); every column the layout or the tape reads is checked
    against the oracles' column counts."""
    tape = q.tape
    if len(q.tid_cols) > MAX_TID:
        raise ValueError("quotient_sweep takes at most %d table-id columns"
                         % MAX_TID)
    terms = tape.code[tape.code[:, 0] == tape_mod.OP_TERM, 1]
    if not np.array_equal(terms, np.arange(q.lookup_terms, q.rem_alpha)):
        raise ValueError("the kernel weighs the tape's terms by a running "
                         "power of alpha: their alphas must run from %d to "
                         "%d without a gap" % (q.lookup_terms, q.rem_alpha))
    smem = 8 * (tape.slots * THREADS + 2 * q.num_var) + 16 * CHUNK
    if smem > MAX_SHARED:
        raise ValueError("quotient_sweep takes %d bytes of shared memory a "
                         "block, more than %d" % (smem, MAX_SHARED))
    wmax = max([q.num_var - 1] + list(tape.wit_cols))
    smax = max([q.num_var - 1] + list(tape.setup_cols))
    if q.lookup:
        wmax = max(wmax, q.mult_col, q.base_off + q.num_subargs * q.pw - 1)
        smax = max([smax, q.table_off + q.num_table - 1] + list(q.tid_cols))
        if ngpow < max(q.width + 1, q.num_table):
            raise ValueError("quotient_sweep needs gamma powers up to the "
                             "table width")
    if wmax >= wit_cols or smax >= setup_cols or st2_cols < q.stage2_cols:
        raise ValueError("a column of the quotient lies outside its oracles "
                         "(%d, %d, %d columns)" % (wit_cols, setup_cols,
                                                  st2_cols))
    tids = list(q.tid_cols)
    return [rows, rows.bit_length() - 1, q.qd, ldw, lds, ld2, q.num_var,
            q.num_inter, int(q.lookup), int(q.specialized), q.num_subargs,
            q.pw, q.base_off, q.width, len(tids), q.table_off, q.num_table,
            q.mult_col, ngpow, len(tape.code), tape.slots] \
        + tids + [0] * (MAX_TID - len(tids))


def scalar_buffer(ch: Challenges, lookup: bool, device) -> torch.Tensor:
    """The kernel's scalars: β, γ, with lookups β_l and [γ^i], then α, each
    (c0, c1), as one int64 tensor on ``device``, made without a wait for
    the device."""
    head = [ch.beta, ch.gamma]
    if lookup:
        head += [ch.lookup_beta] + list(ch.gamma_pows)
    return _scalars(head + [ch.alpha], device)


class Launch:
    """One `quotient_sweep` call on CUDA tensors, its arguments prepared:
    `run` launches the kernel into ``out`` (qd·n, 2), counted
    (`chip_smoke.py` also times it alone)."""

    def __init__(self, q: QuotientInputs, wit, setup, stage2, x_lde, l1,
                 z_shift, vanish, non_res: NonResidues, ch: Challenges,
                 sel=None, program=None):
        from ..utils import cuda_build

        size, dev = x_lde.shape[0], x_lde.device
        rows = size // q.qd
        if rows & (rows - 1):
            raise ValueError("quotient_sweep wants a power-of-two coset, got "
                             "%d rows" % rows)
        wit, setup, stage2 = (t if t.stride(1) == 1 else t.contiguous()
                              for t in (wit, setup, stage2))
        if non_res.tensor.shape != (q.num_var,) \
                or non_res.tensor.device != dev:
            raise ValueError("quotient_sweep wants the %d non-residues on %s"
                             % (q.num_var, dev))
        ngpow = len(ch.gamma_pows) if q.lookup else 0
        scal = scalar_buffer(ch, q.lookup, dev)
        self.params = np.asarray(params(
            q, rows, wit.stride(0), setup.stride(0), stage2.stride(0),
            wit.shape[0], setup.shape[0], stage2.shape[0], ngpow), np.int64)
        if program is None:
            program = upload_tape(q.tape, dev)
        sel = sel.contiguous() if q.lookup and not q.specialized else None
        # the tensors the launch reads, kept alive with it
        self.inputs = (wit, setup, stage2, x_lde.contiguous(),
                       l1.contiguous(), z_shift.contiguous(), sel,
                       vanish.contiguous(), non_res.tensor, scal) + \
            tuple(program)
        self.key = (q, rows, wit.shape[0], setup.shape[0], stage2.shape[0],
                    wit.shape[1] // rows)
        self.out = x_lde.new_empty((size, 2))
        self.lib = cuda_build.load("quotient")
        self.stream = cuda_build.stream_handle(x_lde)

    def run(self):
        from ..utils import cuda_build

        cuda_build.check(self.lib.quotient_sweep(
            *(None if t is None else t.data_ptr() for t in self.inputs),
            self.out.data_ptr(), self.params.ctypes.data, self.stream),
            "quotient_sweep")
        LAUNCHES["quotient_sweep"] += 1
        SHAPES[self.key] += 1


# ---------------------------------------------------------------------------
# Made-up layouts and random inputs, for the checks of the plain version and
# the kernel (the CPU tests, the card's tests and chip_smoke.py)
# ---------------------------------------------------------------------------


def made_up_layout(qd: int, num_var: int, wit_cols: int, setup_cols: int,
                   gates=(), lookup: dict = None) -> QuotientInputs:
    """A layout over a witness of ``wit_cols`` and a setup of
    ``setup_cols`` columns: ``gates`` (evaluator, repetitions, first
    variable column, selector path or None) in the quotient's order, the
    specialized ones (path None) first; a general gate's witness columns
    from ``num_var`` and its constants after its path's setup columns,
    which start at ``num_var``; ``lookup`` the lookup fields of
    `QuotientInputs` (``specialized``, ``num_subargs``, ``width``, ``pw``,
    ``base_off``, ``tid_cols``, ``table_off``, ``num_table``,
    ``mult_col``)."""
    kw = dict(specialized=False, num_subargs=0, width=0, pw=0, base_off=0,
              tid_cols=(), table_off=0, num_table=0, mult_col=0)
    kw.update(lookup or {})
    alpha = kw["num_subargs"] + 1 if lookup else 0
    sweeps = []
    for ev, reps, var_base, path in gates:
        if path is None:
            sweeps.append(tape_mod.GateSweep(ev, reps, var_base, 0, 0, None,
                                             0, alpha))
        else:
            path = tuple(path)
            sweeps.append(tape_mod.GateSweep(
                ev, reps, 0, num_var, num_var + len(path), path, num_var,
                alpha))
        alpha += sweeps[-1].num_terms
    kw["tid_cols"] = tuple(kw["tid_cols"])
    return QuotientInputs(qd=qd, num_var=num_var, lookup=lookup is not None,
                          gates=tuple(sweeps), tape=tape_mod.record_tape(
                              sweeps, wit_cols, setup_cols), **kw)


def random_inputs(rng, q: QuotientInputs, rows: int, wit_cols: int,
                  setup_cols: int, lde: int = None, special=(1, 2)) -> dict:
    """Random canonical host inputs of `quotient_sweep` for the layout
    ``q`` from the numpy generator ``rng``: oracles of ``wit_cols`` /
    ``setup_cols`` / the layout's stage-2 columns over ``lde`` (default qd)
    cosets of ``rows``, x, L1, z(ωx), 1/Z_H a coset, the non-residues, the
    selector (zero on every third point) in the general-purpose lookup
    modes, and the challenges as host pairs (the γ powers up to the table
    width). ``special`` (a, b): every input at point a is 0 and at point b
    p - 1 (with fewer points, none). Returns a dict of numpy arrays and
    Python ints (`args_on` makes the arguments)."""
    P = gl.ORDER
    lde = lde or q.qd
    size = q.qd * rows

    def draw(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    def pairs(k):
        return [tuple(int(v) for v in draw(2)) for _ in range(k)]

    out = dict(wit=draw(wit_cols, lde * rows), setup=draw(setup_cols,
                                                          lde * rows),
               stage2=draw(q.stage2_cols, lde * rows), x=draw(size),
               l1=draw(size), zs=draw(size, 2), vanish=draw(q.qd),
               non_res=[int(v) for v in draw(q.num_var)], sel=None)
    if q.lookup and not q.specialized:
        out["sel"] = draw(size)
        out["sel"][::3] = 0
    for pt, v in zip(special, (0, P - 1)):
        if pt >= size:
            continue
        for name in ("wit", "setup", "stage2"):
            out[name][:, pt] = v
        for name in ("x", "l1", "zs", "sel"):
            if out[name] is not None:
                out[name][pt] = v
    beta, gamma, lbeta = pairs(3)
    ngpow = max(q.width + 1, q.num_table) if q.lookup else 0
    out["ch"] = dict(beta=beta, gamma=gamma, lookup_beta=lbeta,
                     gamma_pows=[(1, 0)] + pairs(ngpow - 1) if ngpow else
                     None, alpha=pairs(1)[0])
    return dict(out, q=q)


def args_on(inputs: dict, device, device_scalars: bool = False) -> tuple:
    """`random_inputs`' values as `quotient_sweep`'s arguments on
    ``device``; with ``device_scalars`` the challenges as device
    `ext2.PreparedExt` (as a device-transcript prove hands them over),
    else host pairs."""
    ch = dict(inputs["ch"])
    if device_scalars:
        def dev(pairs):
            return gl.from_u64(np.asarray(pairs, np.uint64), device)
        ch["beta"], ch["gamma"], ch["lookup_beta"], ch["alpha"] = \
            ext2.prepare(dev([ch["beta"], ch["gamma"], ch["lookup_beta"],
                              ch["alpha"]]))
        if ch["gamma_pows"] is not None:
            ch["gamma_pows"] = ext2.prepare(dev(ch["gamma_pows"]))
    sel = inputs["sel"]
    return (inputs["q"], gl.from_u64(inputs["wit"], device),
            gl.from_u64(inputs["setup"], device),
            gl.from_u64(inputs["stage2"], device),
            gl.from_u64(inputs["x"], device), gl.from_u64(inputs["l1"], device),
            gl.from_u64(inputs["zs"], device),
            gl.from_u64(inputs["vanish"], device),
            NonResidues.make(inputs["non_res"], device), Challenges(**ch),
            None if sel is None else gl.from_u64(sel, device))


def quotient_bound(q: QuotientInputs, rows: int) -> tuple:
    """The least bytes and base-field multiplies of one sweep over qd·rows
    points: every column the layout and the tape read, x, L1, z(ωx) and
    the selector read once, the (c0, c1) output written once; an ext
    product 3 multiplies, an ext scalar times a base value 2 (each lookup
    column, the tape's TERMs), an affine factor 2, a tape MUL 1."""
    wit = set(range(q.num_var)) | set(q.tape.wit_cols)
    setup = set(range(q.num_var)) | set(q.tape.setup_cols)
    # the copy columns' factors, the boundary and the relations, 1/Z_H
    muls = 10 * q.num_var + 3 * (q.num_inter + 2) + 2 + 2
    if q.lookup:
        wit |= {q.mult_col} | set(range(q.base_off, q.base_off
                                        + q.num_subargs * q.pw))
        setup |= set(q.tid_cols) | set(range(q.table_off, q.table_off
                                             + q.num_table))
        muls += q.num_subargs * (2 * (q.pw + bool(q.tid_cols)) + 6) \
            + 2 * q.num_table + 6
    u64 = len(wit) + len(setup) + q.stage2_cols + 4 + 2 + \
        (q.lookup and not q.specialized)
    return 8 * u64 * q.qd * rows, (muls + q.tape.muls()) * q.qd * rows


def made_up_case(name: str) -> tuple:
    """A named made-up layout and its witness and setup column counts (the
    variables, then witness columns and the multiplicity; the sigmas, then
    constants, the table ids among them, and the tables):

    - ``no_lookup``: qd 4, 12 copy columns, a specialized boolean gate, a
      general FMA and a zero check that reads a witness column, each under
      a selector path;
    - ``specialized_ids_per_rep`` / ``specialized_shared_id``: qd 8 / 4, 16
      / 14 copy columns (two whole chunks / a last chunk of 2), 2 width-4
      lookup repetitions from column 6, the table id in a constant column
      each or one shared, a general FMA;
    - ``general_with_sel``: qd 4, 16 copy columns, 2 width-3 lookup
      repetitions from column 0 with their id column, the marker's
      selector, a reduction and an FMA under two-bit paths;
    - ``flagship_like``: the flagship's widths (qd 4, 92 copy columns, 8
      width-4 lookup repetitions with one shared table id, its constants
      allocator, FMA and reduction gates);
    - ``poseidon_gates``: qd 4, 130 copy columns, the flattened Poseidon
      and Poseidon2 gates under one-bit paths."""
    from ..cs.gates.poseidon2_gate import Poseidon2FlattenedEvaluator
    from ..cs.gates.poseidon_gate import PoseidonFlattenedEvaluator
    from ..cs.gates.simple import (BooleanEvaluator,
                                   ConstantsAllocatorEvaluator, FmaEvaluator,
                                   ReductionEvaluator, ZeroCheckEvaluator)
    if name == "no_lookup":
        gates = [(BooleanEvaluator(), 2, 10, None),
                 (FmaEvaluator(), 2, 0, (1, 0)),
                 (ZeroCheckEvaluator(True), 2, 0, (0,))]
        return made_up_layout(4, 12, 15, 16, gates), 15, 16
    if name.startswith("specialized"):
        per_rep = name == "specialized_ids_per_rep"
        nv = 16 if per_rep else 14
        lookup = dict(specialized=True, num_subargs=2, width=4, pw=4,
                      base_off=6, tid_cols=(nv, nv + 1) if per_rep else (nv,),
                      table_off=nv + 4, num_table=5, mult_col=nv)
        return made_up_layout(8 if per_rep else 4, nv, nv + 1, nv + 9,
                              [(FmaEvaluator(), 2, 0, (1,))], lookup), \
            nv + 1, nv + 9
    if name == "general_with_sel":
        lookup = dict(specialized=False, num_subargs=2, width=3, pw=4,
                      base_off=0, table_off=22, num_table=4, mult_col=16)
        gates = [(ReductionEvaluator(4), 2, 0, (0, 1)),
                 (FmaEvaluator(), 2, 0, (1, 1))]
        return made_up_layout(4, 16, 17, 26, gates, lookup), 17, 26
    if name == "flagship_like":
        lookup = dict(specialized=True, num_subargs=8, width=4, pw=4,
                      base_off=60, tid_cols=(92,), table_off=100,
                      num_table=5, mult_col=92)
        gates = [(ConstantsAllocatorEvaluator(), 4, 0, (0, 0, 1)),
                 (FmaEvaluator(), 15, 0, (1,)),
                 (ReductionEvaluator(4), 12, 0, (0, 1))]
        return made_up_layout(4, 92, 93, 105, gates, lookup), 93, 105
    if name == "poseidon_gates":
        gates = [(PoseidonFlattenedEvaluator(), 1, 0, (1,)),
                 (Poseidon2FlattenedEvaluator(), 1, 0, (0,))]
        return made_up_layout(4, 130, 130, 131, gates), 130, 131
    raise ValueError("no made-up case %r" % (name,))


MADE_UP_CASES = ("no_lookup", "specialized_ids_per_rep",
                 "specialized_shared_id", "general_with_sel",
                 "poseidon_gates")
