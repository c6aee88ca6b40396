"""The quotient sweep of the port's prove (`prover/quotient.py`, its gate
tape `cs/gates/tape.py`): the plain version against the JAX reference, the
tape against every gate evaluator, and a Python-int emulation of the Hopper
kernel of `csrc/quotient.cu` against the plain version.

The reference is the JAX `DeviceProver`'s one quotient program
`_quotient_full_fn` (boojum_tpu/prover/device_prover.py:165) taken apart
into the traced bodies it inlines: `_lookup_quotient_body` (:1844),
`_gate_sweep_body` (:1621) for each gate with its selector product built
as that program builds it, and `_copyperm_quotient_body` (:1931), each
called eagerly (compiling the reference's jitted stage programs takes
minutes on XLA:CPU), summed and divided by the vanishing poly as the
program does. Inputs come from a numpy seed (`quotient.random_inputs`);
every comparison is exact.

The emulation runs the kernel's indexing on flat Python-int arrays: the
parameter array the wrapper packs (`quotient.params`, read in the C
struct's order), the scalar array (`quotient.scalar_buffer`: β, γ, with
lookups β_l and the γ powers, then the alphas), the oracles at their row
strides, β·k_j made once a block, the blocks of THREADS points with the
partial last one computing on the last point and storing nothing, the
tape staged CHUNK instructions at a time and run by every thread in
lockstep over slots laid out slot-major and thread-minor, TERM and FLUSH
on the gate's and the point's GL2 sums, and the 16-byte stores. Smaller
blocks and chunks than the kernel's give several blocks, partial blocks
and chunk boundaries at these sizes. Field values are exact residues: the
lazy arithmetic of goldilocks.cuh is held by the emulations of the other
kernels. Change the kernel, change its emulation first."""

import dataclasses
import functools
import inspect
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from boojum_tpu.cs.gates import poseidon2_gate as jpos2
from boojum_tpu.cs.gates import poseidon_gate as jpos
from boojum_tpu.cs.gates import simple as jsimple
from boojum_tpu.field import extension as jext2
from boojum_tpu.field import goldilocks as jgl
from boojum_tpu.field.goldilocks import GL
from boojum_tpu.prover import device_prover as ref_dp
from boojum_tpu.prover.jit_ops import scalar_ext
from boojum_tpu_torch.cs.gates import (arith, base, poseidon2_gate,
                                       poseidon_gate, simple, tape)
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.prover import quotient

P = gl.ORDER
# made-up cases against the JAX reference (the flattened Poseidon gates are
# held by the tape test and the emulation: eagerly their JAX sweep takes
# minutes) -> rows a coset: 256 points each, so that the eager ops' shapes
# (each compiled at its first call) repeat from case to case
JAX_CASES = {"no_lookup": 64, "specialized_ids_per_rep": 32,
             "specialized_shared_id": 64, "general_with_sel": 64}


@functools.lru_cache(maxsize=None)
def make_case(name, rows, lde=8, seed=0):
    q, kw, ks = quotient.made_up_case(name)
    rng = np.random.default_rng(sorted(quotient.MADE_UP_CASES).index(name)
                                + 17 + seed)
    return quotient.random_inputs(rng, q, rows, kw, ks, lde=lde)


def port_plain(inputs, device_scalars=False):
    args = quotient.args_on(inputs, "cpu", device_scalars)
    return gl.to_u64(quotient.quotient_sweep(*args))


# ---------------------------------------------------------------------------
# The JAX reference (boojum_tpu/prover/device_prover.py:165, its bodies)
# ---------------------------------------------------------------------------


def _lohi(a):
    a = np.asarray(a, np.uint64)
    return (jnp.asarray((a & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((a >> np.uint64(32)).astype(np.uint32)))


def _u64(lo, hi):
    return np.asarray(lo, np.uint64) | (np.asarray(hi, np.uint64)
                                        << np.uint64(32))


def _ext_table(pairs):
    return jnp.asarray(np.stack([scalar_ext(p) for p in pairs]))


def _jax_evaluator(ev):
    """The JAX package's evaluator of the port's ``ev``."""
    for mod in (jsimple, jpos, jpos2):
        cls = getattr(mod, type(ev).__name__, None)
        if cls is not None:
            sp = ev.spec_params()
            return cls() if sp is None else cls(sp)
    raise LookupError(type(ev).__name__)


def jax_quotient(inputs):
    """The reference's quotient values on the case -> (qd·n, 2) u64."""
    q, ch = inputs["q"], inputs["ch"]
    size = inputs["x"].shape[0]
    rows = size // q.qd
    w_lo, w_hi = _lohi(inputs["wit"][:, :size].T)
    s_lo, s_hi = _lohi(inputs["setup"][:, :size].T)
    g_lo, g_hi = _lohi(inputs["stage2"][:, :size].T)
    # α^0 .. by the reference's host ladder (its prove without the
    # device transcript)
    alpha_pows = [(1, 0)]
    for _ in range(q.num_alphas - 1):
        alpha_pows.append(jext2.s2_mul(alpha_pows[-1], tuple(ch["alpha"])))
    alphas = _ext_table(alpha_pows)
    num_var = q.num_var
    parts = []
    if q.lookup:
        body = ref_dp._lookup_quotient_body(
            size, q.num_subargs, q.width, q.pw, q.base_off, q.a_off,
            bool(q.tid_cols), not q.specialized, q.num_table,
            q.tid_cols or (0,), q.table_off, q.mult_col)
        sel = inputs["sel"] if inputs["sel"] is not None \
            else np.zeros(size, np.uint64)
        parts.append(body(w_lo, w_hi, s_lo, s_hi, g_lo, g_hi, *_lohi(sel),
                          jnp.asarray(scalar_ext(ch["lookup_beta"])),
                          _ext_table(ch["gamma_pows"]),
                          alphas[:q.lookup_terms]))

    def selector_product(path):
        # as `_quotient_full_fn` builds it (a closure of that program, out
        # of reach): c or 1 - c over the constants, in JAX field ops
        prod = None
        for k, bit in enumerate(path):
            c = GL(s_lo[:, num_var + k], s_hi[:, num_var + k])
            if not bit:
                c = jgl.sub(jgl.ones((size,)), c)
            prod = c if prod is None else jgl.mul(prod, c)
        return jgl.ones((size,)) if prod is None else prod

    for g in q.gates:
        ev = _jax_evaluator(g.evaluator)
        if g.path is None:
            body = ref_dp._gate_sweep_body(ev, g.reps, 0, 0, 0,
                                           spec_base=g.var_base)
            sel = jgl.ones((size,))
        else:
            body = ref_dp._gate_sweep_body(ev, g.reps, 0, g.wit_base,
                                           g.const_base)
            sel = selector_product(g.path)
        parts.append(body(w_lo, w_hi, s_lo, s_hi, sel.lo, sel.hi,
                          alphas[g.alpha:g.alpha + g.num_terms]))
    cp = ref_dp._copyperm_quotient_body(size, rows, q.qd, num_var,
                                        q.num_inter)
    zs = inputs["zs"]
    parts.append(cp(w_lo, w_hi, s_lo, s_hi, *_lohi(inputs["x"]),
                    *_lohi(inputs["non_res"]), g_lo, g_hi, *_lohi(zs[:, 0]),
                    *_lohi(zs[:, 1]), *_lohi(inputs["l1"]),
                    jnp.asarray(scalar_ext(ch["beta"])),
                    jnp.asarray(scalar_ext(ch["gamma"])),
                    alphas[q.rem_alpha:]))
    acc = np.zeros((size, 2), object)
    for out in parts:
        acc[:, 0] += _u64(out[0], out[1]).astype(object)
        acc[:, 1] += _u64(out[2], out[3]).astype(object)
    van = np.repeat(inputs["vanish"].astype(object), rows)
    return ((acc % P) * van[:, None] % P).astype(np.uint64)


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_plain_equals_jax_reference(name):
    inputs = make_case(name, JAX_CASES[name])
    got = port_plain(inputs)
    np.testing.assert_array_equal(got, jax_quotient(inputs))
    # the device forms of the challenges (one alpha table) give the same
    np.testing.assert_array_equal(port_plain(inputs, True), got)


# ---------------------------------------------------------------------------
# The tape against every evaluator
# ---------------------------------------------------------------------------

EVALUATORS = {
    "MatrixMulEvaluator": lambda c: c((3, [[1, 2, 3], [4, 5, 6],
                                          [7, 8, P - 9]])),
    "SimpleNonlinearityEvaluator": lambda c: c(7),
    "UIntXAddEvaluator": lambda c: c(16),
    "BoundedBooleanEvaluator": lambda c: c(3),
    "BoundedConstantsAllocatorEvaluator": lambda c: c(2),
    "ConditionalSwapEvaluator": lambda c: c(2),
    "ConstantsAsConstraintEvaluator": lambda c: c((5, P - 2)),
    "DotProductEvaluator": lambda c: c(4),
    "LookupMarkerEvaluator": lambda c: c(4, True),
    "ParallelSelectionEvaluator": lambda c: c(4),
    "QuadraticCombinationEvaluator": lambda c: c(4),
    "ReductionByPowersEvaluator": lambda c: c(4),
    "ReductionEvaluator": lambda c: c(4),
    "ZeroCheckEvaluator": lambda c: c(True),
}


def _evaluator_classes():
    out = {}
    for mod in (arith, simple, poseidon_gate, poseidon2_gate):
        for name, cls in inspect.getmembers(mod, inspect.isclass):
            if issubclass(cls, base.GateEvaluator) \
                    and cls.__module__ == mod.__name__:
                out[name] = cls
    return out


EVALUATOR_CLASSES = _evaluator_classes()


@pytest.mark.parametrize("name", sorted(EVALUATOR_CLASSES))
def test_tape_replays_evaluator(name):
    """One repetition of the evaluator as a general gate under the path
    (1, 0), recorded and replayed on Python ints at a few points, against
    the evaluator under `NpOps`: every term, the selector, the slots."""
    cls = EVALUATOR_CLASSES[name]
    ev = EVALUATORS.get(name, lambda c: c())(cls)
    num_var, path = max(ev.num_variables, 1), (1, 0)
    wit_cols, setup_cols = num_var + 4, num_var + len(path) + 8
    g = tape.GateSweep(ev, 1, 0, num_var, num_var + len(path), path,
                       num_var, 0)
    rec = tape.record_tape([g], wit_cols, setup_cols)
    rng = np.random.default_rng(len(name))
    pts = 3
    w = rng.integers(0, P, (wit_cols, pts), dtype=np.uint64)
    s = rng.integers(0, P, (setup_cols, pts), dtype=np.uint64)
    want = ev.evaluate(base.TraceView(list(w), list(w[num_var:]),
                                      list(s[num_var + len(path):])),
                       base.NpOps)
    assert len(want) == ev.num_quotient_terms == g.num_terms
    assert 8 * rec.slots * quotient.THREADS < quotient.MAX_SHARED // 2
    for pt in range(pts):
        terms, flushes = tape.replay(rec, lambda c: int(w[c, pt]),
                                     lambda c: int(s[c, pt]))
        got = dict(terms)
        assert len(got) == len(terms)  # each alpha once
        for k, t in enumerate(want):
            assert got.get(k, 0) == int(np.broadcast_to(t, (pts,))[pt]), k
        sel = int(s[num_var, pt]) * (1 - int(s[num_var + 1, pt])) % P
        assert flushes == [(None, sel)]


def test_every_evaluator_has_a_case():
    assert set(EVALUATORS) <= set(EVALUATOR_CLASSES)
    assert len(EVALUATOR_CLASSES) >= 27


def test_tape_folds_and_merges():
    ops = tape.TapeOps()
    x, c = ("w", 3), ("s", 5)
    assert ops.mul(ops.from_int(3), ops.from_int(5)) == ("c", 15)
    assert ops.sub(ops.zero(), ops.one()) == ("c", P - 1)
    assert ops.mul(x, ops.one()) == x and ops.add(ops.zero(), x) == x
    assert ops.sub(x, ops.zero()) == x and ops.mul(ops.zero(), x) == ("c", 0)
    assert ops.mul(x, c) == ops.mul(c, x) and len(ops.nodes) == 1
    assert ops.sub(x, c) != ops.sub(c, x) and len(ops.nodes) == 3
    ops.forget()
    assert ops.mul(x, c) == ("r", 3)


# ---------------------------------------------------------------------------
# Emulation of csrc/quotient.cu
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cu_constants():
    """The integer constants of csrc/quotient.cu by name."""
    text = open(os.path.join(os.path.dirname(quotient.__file__), "..",
                             "csrc", "quotient.cu")).read()
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", text):
        for part in decl.split(","):
            name, value = (s.strip() for s in part.split("="))
            out[name] = eval(value, {}, dict(out))
    return out


CU = _cu_constants()
# the C struct's scalar fields, in the parameter array's order
PARAM_NAMES = ("n", "log_n", "qd", "ldw", "lds", "ld2", "num_var",
               "num_inter", "lookup", "specialized", "nsub", "pw",
               "base_off", "width", "ntid", "table_off", "ntab", "mult_col",
               "ngpow", "tape_len", "slots")


def e2_mul(a, b):
    v0, v1 = a[0] * b[0], a[1] * b[1]
    s = (a[0] + a[1]) * (b[0] + b[1])
    return ((v0 + 7 * v1) % P, (s - v0 - v1) % P)


def emulate(args, threads=CU["THREADS"], chunk=CU["CHUNK"]):
    """`quotient_sweep`'s kernel on ``args`` (CPU tensors) -> (qd·n, 2)
    u64; ``threads`` a block and ``chunk`` staged instructions."""
    q, wit, setup, stage2, x, l1, zs, vanish, non_res, ch, sel = args
    size = x.shape[0]
    ngpow = len(ch.gamma_pows) if q.lookup else 0
    raw = quotient.params(q, size // q.qd, wit.stride(0), setup.stride(0),
                          stage2.stride(0), wit.shape[0], setup.shape[0],
                          stage2.shape[0], ngpow)
    assert len(raw) == CU["NUM_PARAMS"] == len(PARAM_NAMES) + CU["MAX_TID"]
    p = dict(zip(PARAM_NAMES, raw))
    tid = raw[len(PARAM_NAMES):]

    def mem(t):  # a tensor's memory as the kernel's pointer sees it
        return [int(v) for v in gl.to_u64(t).reshape(-1)]

    W, S, S2 = mem(wit), mem(setup), mem(stage2)
    X, L1, ZS, VAN, NR = mem(x), mem(l1), mem(zs), mem(vanish), \
        mem(non_res.tensor)
    SEL = mem(sel) if sel is not None else None
    SCAL = mem(quotient.scalar_buffer(ch, q.lookup, "cpu"))
    TAPE = q.tape.code.reshape(-1).tolist()
    CONSTS = [int(c) for c in q.tape.consts]
    size = p["qd"] << p["log_n"]
    assert size == x.shape[0] and p["n"] == 1 << p["log_n"]
    beta, gamma = tuple(SCAL[0:2]), tuple(SCAL[2:4])
    gpow = 6
    alpha_at = 4 + (2 + 2 * p["ngpow"] if p["lookup"] else 0)
    a_off = 2 * (1 + p["num_inter"])
    out = [None] * (2 * size)

    def pair(i):
        return (SCAL[i], SCAL[i + 1])

    def add_scaled(acc, b, g):
        return ((acc[0] + b * g[0]) % P, (acc[1] + b * g[1]) % P)

    def e2_add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    for blk in range(-(-size // threads)):
        idx = [blk * threads + t for t in range(threads)]
        pts = [min(i, size - 1) for i in idx]
        slots = [None] * (p["slots"] * threads)
        bk = [0] * (2 * p["num_var"])
        for j in range(p["num_var"]):
            bk[2 * j] = beta[0] * NR[j] % P
            bk[2 * j + 1] = beta[1] * NR[j] % P
        alpha = pair(alpha_at)
        # each thread's α^k of its next term, in the alphas' order
        apow = [(1, 0)] * threads

        def weigh(t, term):
            r = e2_mul(term, apow[t])
            apow[t] = e2_mul(apow[t], alpha)
            return r

        def wcol(c, pt):
            return W[c * p["ldw"] + pt]

        def scol(c, pt):
            return S[c * p["lds"] + pt]

        def s2pair(c, pt):
            return (S2[c * p["ld2"] + pt], S2[(c + 1) * p["ld2"] + pt])

        acc = []
        for t, pt in enumerate(pts):
            a = (0, 0)
            if p["lookup"]:
                one = 1 if p["specialized"] else SEL[pt]
                for r in range(p["nsub"]):
                    agg = pair(4)
                    first = p["base_off"] + r * p["pw"]
                    for c in range(p["pw"]):
                        agg = add_scaled(agg, wcol(first + c, pt),
                                         pair(gpow + 2 * c))
                    if p["ntid"]:
                        agg = add_scaled(agg, scol(tid[min(r, p["ntid"] - 1)],
                                                   pt),
                                         pair(gpow + 2 * p["width"]))
                    term = e2_mul(s2pair(a_off + 2 * r, pt), agg)
                    term = ((term[0] - one) % P, term[1])
                    a = e2_add(a, weigh(t, term))
                agg = pair(4)
                for c in range(p["ntab"]):
                    agg = add_scaled(agg, scol(p["table_off"] + c, pt),
                                     pair(gpow + 2 * c))
                term = e2_mul(s2pair(a_off + 2 * p["nsub"], pt), agg)
                term = ((term[0] - wcol(p["mult_col"], pt)) % P, term[1])
                a = e2_add(a, weigh(t, term))
            acc.append(a)

        # the tape, every thread in lockstep
        gacc = [(0, 0)] * threads

        def operand(v, t):
            i, kind = v >> 2, v & 3
            if kind == CU["SLOT"]:
                return slots[i * threads + t]
            if kind == CU["WIT"]:
                return wcol(i, pts[t])
            if kind == CU["SETUP"]:
                return scol(i, pts[t])
            return CONSTS[i]

        for first in range(0, p["tape_len"], chunk):
            count = min(chunk, p["tape_len"] - first)
            code = [None] * chunk
            for t in range(threads):  # the block's staging
                for k in range(t, count, threads):
                    code[k] = TAPE[4 * (first + k):4 * (first + k) + 4]
            for op, dst, va, vb in code[:count]:
                for t in range(threads):
                    if op <= CU["OP_MUL"]:
                        u, v = operand(va, t), operand(vb, t)
                        slots[dst * threads + t] = (
                            u + v if op == CU["OP_ADD"] else u - v
                            if op == CU["OP_SUB"] else u * v) % P
                    elif op == CU["OP_TERM"]:
                        gacc[t] = add_scaled(gacc[t], operand(va, t),
                                             apow[t])
                        apow[t] = e2_mul(apow[t], alpha)
                    else:
                        assert op == CU["OP_FLUSH"]
                        g = gacc[t]
                        if dst:
                            sv = operand(va, t)
                            g = (g[0] * sv % P, g[1] * sv % P)
                        acc[t] = e2_add(acc[t], g)
                        gacc[t] = (0, 0)

        # the copy permutation, then 1/Z_H and the store
        for t, pt in enumerate(pts):
            z = s2pair(0, pt)
            xv = X[pt]
            zm1 = ((z[0] - 1) * L1[pt] % P, z[1] * L1[pt] % P)
            a = e2_add(acc[t], weigh(t, zm1))
            for rel in range(p["num_inter"] + 1):
                lhs = s2pair(2 + 2 * rel, pt) if rel < p["num_inter"] \
                    else (ZS[2 * pt], ZS[2 * pt + 1])
                rhs = z if rel == 0 else s2pair(2 * rel, pt)
                for j in range(rel * p["qd"], min(rel * p["qd"] + p["qd"],
                                                  p["num_var"])):
                    w, s = wcol(j, pt), scol(j, pt)
                    lhs = e2_mul(lhs, ((w + s * beta[0] + gamma[0]) % P,
                                       (s * beta[1] + gamma[1]) % P))
                    rhs = e2_mul(rhs, ((w + xv * bk[2 * j] + gamma[0]) % P,
                                       (xv * bk[2 * j + 1] + gamma[1]) % P))
                a = e2_add(a, weigh(t, ((lhs[0] - rhs[0]) % P,
                                        (lhs[1] - rhs[1]) % P)))
            v = VAN[pt >> p["log_n"]]
            if idx[t] < size:
                out[2 * idx[t]:2 * idx[t] + 2] = [a[0] * v % P, a[1] * v % P]
    assert None not in out
    return np.asarray(out, np.uint64).reshape(size, 2)


# (case, rows a coset, threads a block, instructions a chunk): the kernel's
# sizes (a full block; one partial block at 32 points), and smaller ones
# for several blocks, a partial last one and chunk boundaries
EMULATION = [("no_lookup", 32, CU["THREADS"], CU["CHUNK"]),
             ("no_lookup", 16, 48, 7),
             ("specialized_ids_per_rep", 8, 40, 5),
             ("specialized_shared_id", 8, CU["THREADS"], CU["CHUNK"]),
             ("general_with_sel", 32, 96, 11),
             ("poseidon_gates", 8, 24, CU["CHUNK"])]


@pytest.mark.parametrize("name,rows,threads,chunk", EMULATION)
def test_kernel_emulation_matches_plain(name, rows, threads, chunk):
    inputs = make_case(name, rows, lde=None if rows < 16 else 8, seed=1)
    for device_scalars in ((False, True) if rows > 8 else (True,)):
        args = quotient.args_on(inputs, "cpu", device_scalars)
        want = gl.to_u64(quotient.quotient_plain(*args))
        np.testing.assert_array_equal(emulate(args, threads, chunk), want)


def test_circuit_layout_emulation_matches_plain():
    """The layout and tape of a real circuit (`QuotientInputs.of_circuit`
    on the tests' small circuit: its gates' columns, selector paths and
    alphas) through the emulation against the plain version."""
    from tests.torch_small_circuit import small_circuits
    sc = small_circuits()
    cs, sb = sc["cs"], sc["sb"]
    q = quotient.QuotientInputs.of_circuit(cs, sb)
    _, kw, ks = tape.quotient_gates(cs, sb)
    assert [g.alpha for g in q.gates] == list(np.cumsum(
        [q.lookup_terms] + [g.num_terms for g in q.gates])[:-1])
    inputs = quotient.random_inputs(np.random.default_rng(4), q, 8, kw, ks,
                                    lde=q.qd)
    args = quotient.args_on(inputs, "cpu", True)
    np.testing.assert_array_equal(
        emulate(args, 16, 64), gl.to_u64(quotient.quotient_plain(*args)))


def test_kernel_constants_match_wrapper():
    assert (CU["THREADS"], CU["CHUNK"], CU["MAX_TID"]) == (
        quotient.THREADS, quotient.CHUNK, quotient.MAX_TID)
    assert (CU["OP_ADD"], CU["OP_SUB"], CU["OP_MUL"], CU["OP_TERM"],
            CU["OP_FLUSH"]) == (tape.OP_ADD, tape.OP_SUB, tape.OP_MUL,
                                tape.OP_TERM, tape.OP_FLUSH)
    assert (CU["SLOT"], CU["WIT"], CU["SETUP"]) == (tape.SLOT, tape.WIT,
                                                    tape.SETUP)


def test_params_check_columns_slots_and_alphas():
    q, kw, ks = quotient.made_up_case("specialized_shared_id")
    args, g = (q, 64, 512, 512, 512), max(q.width + 1, q.num_table)
    quotient.params(*args, kw, ks, q.stage2_cols, g)
    for bad in ((kw - 1, ks, q.stage2_cols, g), (kw, ks - 1, q.stage2_cols, g),
                (kw, ks, q.stage2_cols - 1, g), (kw, ks, q.stage2_cols, g - 1)):
        with pytest.raises(ValueError):
            quotient.params(*args, *bad)
    many = dataclasses.replace(q, tape=dataclasses.replace(
        q.tape, slots=quotient.MAX_SHARED // (8 * quotient.THREADS)))
    with pytest.raises(ValueError):
        quotient.params(many, *args[1:], kw, ks, q.stage2_cols, g)
    code = q.tape.code.copy()  # a gap in the TERMs' alphas
    code[np.nonzero(code[:, 0] == tape.OP_TERM)[0][0], 1] += 1
    gap = dataclasses.replace(q, tape=dataclasses.replace(q.tape, code=code))
    with pytest.raises(ValueError):
        quotient.params(gap, *args[1:], kw, ks, q.stage2_cols, g)


def test_wrapper_takes_cpu_tensors_only_through_plain():
    inputs = make_case("no_lookup", 16, lde=4)
    args = quotient.args_on(inputs, "cpu")
    before = quotient.PLAIN_CUDA_CALLS, dict(quotient.LAUNCHES)
    quotient.quotient_sweep(*args)
    assert (quotient.PLAIN_CUDA_CALLS, dict(quotient.LAUNCHES)) == before
    with pytest.raises(TypeError):
        quotient.quotient_sweep(*args[:5], args[5][:-1], *args[6:])
