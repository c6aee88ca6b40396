"""The port's copies of the host circuit library (`gadgets/wrappers.py`,
`queue.py`, `blake2s.py`, `non_native.py`, `curves.py`,
`cs/gates/testing.py`, `utils/native.py`) against the JAX package's.

Each case is one non-slow case of `tests/test_wrappers.py`,
`test_wrapper_parity.py`, `test_wide_uints.py`, `test_blake2s_gadget.py`,
`test_non_native.py`, `test_gate_testing_tools.py` or `test_native.py`,
built in both packages from the same `default_rng` seed through the same
code (each case is written once against either package's modules). It
checks: the gadgets' outputs are equal (and the values the JAX test
expects); `final_trace_len` and the resolver's values are equal; every
array and field of `create_base_setup` is equal; `check_if_satisfied`
gives the JAX test's answer in both; where the JAX test corrupts a
witness, the same corruption fails the port. No VK and no proof: these
modules are host code with no device twin."""

import hashlib
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from boojum_tpu.cs import places as ref_places
from boojum_tpu.cs.gates import testing as ref_testing
from boojum_tpu.utils import native as ref_native
from boojum_tpu.utils import npgl as ref_npgl
from boojum_tpu_torch.cs import places
from boojum_tpu_torch.cs.gates import testing
from boojum_tpu_torch.cs.gates.base import GateEvaluator
from boojum_tpu_torch.utils import native, npgl

P = (1 << 64) - (1 << 32) + 1
BN254 = 21888242871839275222246405745257275088696311157297823662689037894645226208583
SECP_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
SB_ARRAYS = ("copy_permutation_polys", "constant_columns",
             "lookup_tables_columns")
SB_FIELDS = ("table_ids_column_idxes", "selector_paths", "quotient_degree",
             "num_general_constant_columns", "domain_size", "public_inputs")


def _mods(pkg):
    names = dict(cs=".cs", gates=".cs.gates", arith=".cs.gates.arith",
                 places=".cs.places", setup=".cs.setup",
                 tables=".gadgets.tables", sha=".gadgets.sha256",
                 uints=".gadgets.uints", w=".gadgets.wrappers",
                 q=".gadgets.queue", p2c=".gadgets.poseidon2_circuit",
                 b2s=".gadgets.blake2s", nn=".gadgets.non_native",
                 cv=".gadgets.curves")
    return SimpleNamespace(**{k: importlib.import_module(pkg + v)
                              for k, v in names.items()})


# ---------------------------------------------------------------------------
# the JAX tests' circuit set-ups, against either package
# ---------------------------------------------------------------------------


def wrappers_cs(m, with_tables=True, max_trace=1 << 14):
    """tests/test_wrappers.py:make_cs."""
    g = m.gates
    cs = m.cs.ConstraintSystem(m.cs.CSGeometry(60, 0, 4, 4), max_trace,
                               m.cs.CSConfig.dev())
    if with_tables:
        cs.allow_lookup(
            m.cs.LookupParameters.specialized_with_table_id_as_constant(
                width=4, num_repetitions=8, share_table_id=True))
    for gate in (g.ConstantsAllocatorGate, g.FmaGate, g.NopGate,
                 g.BooleanConstraintGate, g.SelectionGate, g.ZeroCheckGate,
                 g.U32AddGate, g.U32SubGate):
        cs.allow_gate(gate)
    cs.allow_gate(g.ReductionGate, params=4)
    m.p2c.allow_poseidon2_gates(cs)
    tids = m.sha.add_sha256_tables(cs) if with_tables else None
    return cs, tids


def range8_cs(m, max_trace_log, parity):
    """tests/test_wrapper_parity.py:make_cs (``parity``) and
    tests/test_wide_uints.py:make_cs."""
    g = m.gates
    geom = m.cs.CSGeometry(num_columns_under_copy_permutation=32,
                           num_witness_columns=0, num_constant_columns=4,
                           max_allowed_constraint_degree=4)
    cs = m.cs.ConstraintSystem(geom, 1 << max_trace_log, m.cs.CSConfig.dev())
    cs.allow_lookup(m.cs.LookupParameters.specialized_with_table_id_as_constant(
        width=3, num_repetitions=4, share_table_id=True))
    if parity:
        for gate in (g.ConstantsAllocatorGate, g.FmaGate,
                     g.BooleanConstraintGate, g.SelectionGate,
                     m.arith.U32AddGate, m.arith.U32SubGate,
                     m.arith.U8x4FMAGate, g.ConditionalSwapGate, g.NopGate):
            cs.allow_gate(gate)
        cs.allow_gate(g.ReductionGate, params=4)
        cs.allow_gate(g.DotProductGate, params=4)
        cs.allow_gate(g.ZeroCheckGate, params=False)
    else:
        cs.allow_gate(g.ConstantsAllocatorGate)
        cs.allow_gate(g.FmaGate)
        cs.allow_gate(g.ReductionGate, params=4)
        for gate in (g.BooleanConstraintGate, g.SelectionGate,
                     m.arith.U32AddGate, m.arith.U32SubGate,
                     m.arith.U8x4FMAGate):
            cs.allow_gate(gate)
        cs.allow_gate(g.ZeroCheckGate, params=False)
        cs.allow_gate(g.NopGate)
    tids = {"range8": cs.add_lookup_table(
        m.tables.create_range_check_table(8, width=3))}
    return cs, tids


# ---------------------------------------------------------------------------
# the cases, each returning `_finish`'s tuple
# ---------------------------------------------------------------------------


def _finish(cs, out, want, ok=True, corrupt=None):
    """A case's result: the circuit, the gadgets' outputs, the values the
    JAX test expects of them, whether the circuit is satisfied, and the
    corruption that must unsatisfy it (or None)."""
    return cs, out, want, ok, corrupt


def num_boolean(m, rng):
    cs, _ = wrappers_cs(m, with_tables=False, max_trace=1 << 10)
    Num, Boolean = m.w.Num, m.w.Boolean
    a, b = Num.allocate(cs, 123456789), Num.allocate(cs, 987654321)
    t, f = Boolean.allocate(cs, True), Boolean.allocate(cs, False)
    out = [a.add(b), a.mul(b), a.sub(b), a.equals(b), a.equals(a),
           t.and_(f), t.or_(f), f.not_(), a.select(t, b), a.select(f, b)]
    want = [(123456789 + 987654321) % P, (123456789 * 987654321) % P,
            (123456789 - 987654321) % P, False, True, False, True, True,
            123456789, 987654321]
    return _finish(cs, [o.get_witness() for o in out], want)


def uints(m, rng):
    cs, tids = wrappers_cs(m)
    w = m.w
    vals = [w.UInt8.allocate_checked(cs, 0xAB, tids),
            w.UInt16.allocate_checked(cs, 0xBEEF, tids),
            w.UInt32.allocate_checked(cs, 0xDEADBEEF, tids),
            w.UInt64.allocate_checked(cs, 0x0123456789ABCDEF, tids)]
    a = w.UInt32.allocate_checked(cs, 0xFFFFFFF0, tids)
    b = w.UInt32.allocate_checked(cs, 0x20, tids)
    c, carry = a.add(b)
    out = [v.get_witness() for v in vals] + [c.get_witness(),
                                             carry.get_witness()]
    want = [0xAB, 0xBEEF, 0xDEADBEEF, 0x0123456789ABCDEF, 0x10, True]
    return _finish(cs, out, want)


def uint_range_check(m, rng):
    """tests/test_wrappers.py::test_uint_range_check_catches_bad_value."""
    cs, tids = wrappers_cs(m)
    v = m.w.UInt8.allocate_checked(cs, 0x12, tids)

    def corrupt(cs):
        cs.resolver.values[v.variable] = 0x1234
    return _finish(cs, [v.get_witness()], [0x12], True, corrupt)


def _push_pop(cs, q, items):
    for it in items:
        q.push([cs.alloc_variable_with_value(v) for v in it])
    popped = []
    while q.length:
        popped.append([cs.get_value(v) for v in q.pop()])
    q.enforce_consistency()
    return popped


def circuit_queue(m, rng):
    cs, _ = wrappers_cs(m, with_tables=False)
    items = [[int(x) for x in rng.integers(0, P, 4, dtype=np.uint64)]
             for _ in range(5)]
    popped = _push_pop(cs, m.q.CircuitQueue(cs, element_width=4), items)
    return _finish(cs, popped, items)


def multilimb_uints(m, rng):
    cs, tids = wrappers_cs(m)
    w = m.w
    a_val = 0xDEADBEEF_12345678_9ABCDEF0_13579BDF_2468ACE0
    b_val = 0x1111111F_FFFFFFFF_00000001_FFFFFFFF_FFFFFFFF
    a = w.UInt160.allocate_checked(cs, a_val, tids)
    b = w.UInt160.allocate_checked(cs, b_val, tids)
    s, ovf = a.add(b)
    d, brw = a.sub(b)
    t = w.Boolean.allocate(cs, True)
    z = w.UInt256.allocate_checked(cs, 0, tids)
    wv = w.UInt512.allocate_checked(cs, (1 << 511) | 7, tids)
    out = [s, ovf, d, brw, a.select(t, b), a.select(t.not_(), b),
           a.is_zero(), z.is_zero(), wv]
    want = [(a_val + b_val) % (1 << 160), (a_val + b_val) >> 160 > 0,
            (a_val - b_val) % (1 << 160), a_val < b_val, a_val, b_val,
            False, True, (1 << 511) | 7]
    return _finish(cs, [o.get_witness() for o in out], want)


def full_state_queue(m, rng):
    cs, _ = wrappers_cs(m, with_tables=False)
    items = [[int(x) for x in rng.integers(0, P, 8, dtype=np.uint64)]
             for _ in range(3)]
    popped = _push_pop(cs, m.q.FullStateCircuitQueue(cs, element_width=8),
                       items)
    return _finish(cs, popped, items)


def sponge_optimizer_queues(m, rng):
    g = m.gates
    cs = m.cs.ConstraintSystem(m.cs.CSGeometry(132, 0, 4, 8), 1 << 10,
                               m.cs.CSConfig.dev())
    for gate in (g.ConstantsAllocatorGate, g.FmaGate, g.NopGate):
        cs.allow_gate(gate)
    cs.allow_gate(g.ReductionGate, params=4)
    m.p2c.allow_poseidon2_gates(cs, flattened=True)
    opt = m.q.SpongeOptimizer(cs)
    queues = [m.q.OptimizedCircuitQueue(cs, opt) for _ in range(3)]
    plain = [m.q.FullStateCircuitQueue(cs) for _ in range(3)]
    items = [[int(x) for x in rng.integers(0, P, 8, dtype=np.uint64)]
             for _ in range(6)]
    for cycle in range(2):
        for qi in range(3):
            vs = [cs.alloc_variable_with_value(v)
                  for v in items[cycle * 3 + qi]]
            queues[qi].push(vs)
            plain[qi].push(vs)
        opt.flush()
    tails = [[cs.get_value(v) for v in q.tail] for q in queues]
    want = [[cs.get_value(v) for v in q.tail] for q in plain]
    for cycle in range(2):
        for q in queues:
            q.pop()
        opt.flush()
    for q in queues:
        q.enforce_consistency()
    return _finish(cs, tails, want)


def num_linear_combination_and_dot_product(m, rng):
    cs, _ = range8_cs(m, 13, True)
    Num = m.w.Num
    vals = [int(x) for x in rng.integers(0, P, 7, dtype=np.uint64)]
    coeffs = [int(x) for x in rng.integers(0, P, 7, dtype=np.uint64)]
    nums = [Num.allocate(cs, v) for v in vals]
    lc = Num.linear_combination(cs, list(zip(coeffs, nums)))
    Num.enforce_zero_for_linear_combination(
        cs, list(zip(coeffs, nums)) + [(P - lc.get_witness(),
                                        Num.constant(cs, 1))])
    dp = Num.dot_product(cs, nums, [Num.allocate(cs, v) for v in vals])
    return _finish(cs, [lc.get_witness(), dp.get_witness()],
                   [sum(c * v for c, v in zip(coeffs, vals)) % P,
                    sum(v * v for v in vals) % P])


def num_fma_inverse_swap_mask(m, rng):
    cs, _ = range8_cs(m, 13, True)
    Num, Boolean = m.w.Num, m.w.Boolean
    a, b, c = (Num.allocate(cs, v) for v in (0xDEAD, 0xBEEF, 0x1234))
    r = Num.fma(cs, a, b, 3, c, 5)
    inv = a.inverse_unchecked()
    t, f = Boolean.allocate(cs, True), Boolean.allocate(cs, False)
    out = [r.get_witness(), inv.get_witness()]
    out += [v.get_witness() for v in Num.conditionally_swap(t, a, b)]
    out += [v.get_witness() for v in Num.conditionally_swap(f, a, b)]
    out += [a.mask(t).get_witness(), a.mask(f).get_witness(),
            a.mask_negated(f).get_witness()]
    a.enforce_equal(Num.allocate(cs, 0xDEAD))
    a.conditionally_enforce_equal(f, b)
    a.conditionally_enforce_equal(t, Num.allocate(cs, 0xDEAD))
    out.append([bit.get_witness() for bit in
                Num.allocate(cs, 0b101101).spread_into_bits(6)])
    want = [(3 * 0xDEAD * 0xBEEF + 5 * 0x1234) % P, pow(0xDEAD, P - 2, P),
            0xBEEF, 0xDEAD, 0xDEAD, 0xBEEF, 0xDEAD, 0, 0xDEAD,
            [1, 0, 1, 1, 0, 1]]
    return _finish(cs, out, want)


def num_conditional_enforce_bites(m, rng):
    cs, _ = range8_cs(m, 13, True)
    a, b = m.w.Num.allocate(cs, 1), m.w.Num.allocate(cs, 2)
    a.conditionally_enforce_equal(m.w.Boolean.allocate(cs, True), b)
    return _finish(cs, [], [], ok=False)


def boolean_parity_ops(m, rng):
    cs, _ = range8_cs(m, 13, True)
    Boolean = m.w.Boolean
    t, f = Boolean.allocate(cs, True), Boolean.allocate(cs, False)
    out = [t.xor(f), t.xor(t), t.equals(t), t.equals(f),
           Boolean.multi_and(cs, [t, t, t]), Boolean.multi_and(cs, [t, f, t]),
           Boolean.multi_or(cs, [f, f, t]), Boolean.multi_or(cs, [f, f, f]),
           t.mask(f), t.mask_negated(f), t.select(f, f),
           Boolean.constant(cs, True),
           Boolean.from_variable_checked(cs,
                                         cs.alloc_variable_with_value(1))]
    out = [o.get_witness() for o in out]
    t.enforce_equal(Boolean.allocate(cs, True))
    t.conditionally_enforce_true(t)
    f.conditionally_enforce_false(t)
    f.conditionally_enforce_true(f)
    want = [True, False, True, False, True, False, True, False, False, True,
            False, True, True]
    return _finish(cs, out, want)


def boolean_conditional_enforce_bites(m, rng):
    cs, _ = range8_cs(m, 13, True)
    t, f = m.w.Boolean.allocate(cs, True), m.w.Boolean.allocate(cs, False)
    f.conditionally_enforce_true(t)
    return _finish(cs, [], [], ok=False)


def uint32_fma_with_carry_and_mul(m, rng):
    cs, tids = range8_cs(m, 13, True)
    U = m.w.UInt32
    av, bv, cv, dv = (int(x) for x in rng.integers(0, 1 << 32, 4,
                                                   dtype=np.uint64))
    a, b, c, d = (U.allocate_checked(cs, v, tids) for v in (av, bv, cv, dv))
    low, high = a.fma_with_carry(b, c, d, tids)
    s = U.allocate_checked(cs, 0x1234, tids)
    t = U.allocate_checked(cs, 0x5678, tids)
    total = av * bv + cv + dv
    return _finish(cs, [low.get_witness(), high.get_witness(),
                        s.non_widening_mul(t, tids).get_witness()],
                   [total & 0xFFFFFFFF, total >> 32, 0x1234 * 0x5678])


def uint32_div_and_views(m, rng):
    cs, tids = range8_cs(m, 13, True)
    U, Boolean = m.w.UInt32, m.w.Boolean
    v = 0xDEADBEEF
    a = U.allocate_checked(cs, v, tids)
    q, r = a.div_by_constant(1000, tids)
    lo, hi = a.decompose_into_uint16(tids)
    le = a.to_le_bytes(tids)
    out = [q.get_witness(), r.get_witness(), a.div2(tids).get_witness(),
           lo.get_witness(), hi.get_witness(),
           a.low_u16(tids).get_witness(), [x.get_witness() for x in le],
           [x.get_witness() for x in a.to_be_bytes(tids)]]
    back = U.from_le_bytes(cs, le, tids)
    back.enforce_range(tids)
    b = U.allocate_checked(cs, 7, tids)
    d, brw = b.sub(a)
    flag = Boolean.allocate(cs, False)
    out += [back.get_witness(), b.increment_checked(tids).get_witness(),
            a.add_no_overflow(b, tids).get_witness(), d.get_witness(),
            brw.get_witness(), a.sub_no_overflow(b, tids).get_witness(),
            a.equals(U.allocate_checked(cs, v, tids)).get_witness(),
            a.is_zero().get_witness(), a.select(flag, b).get_witness(),
            a.mask(flag).get_witness()]
    want = [*divmod(v, 1000), v >> 1, v & 0xFFFF, v >> 16, v & 0xFFFF,
            list(v.to_bytes(4, "little")), list(v.to_bytes(4, "big")), v, 8,
            v + 7, (7 - v) % (1 << 32), True, v - 7, True, False, 7, 0]
    return _finish(cs, out, want)


def uint32_div_by_constant_bad_remainder(m, rng):
    cs, tids = range8_cs(m, 13, True)
    a = m.w.UInt32.allocate_checked(cs, 1000001, tids)
    q, r = a.div_by_constant(1000, tids)
    cs.resolver.values[q.variable] = 999
    cs.resolver.values[r.variable] = 1001
    return _finish(cs, [], [], ok=False)


def uint16_generic_sub(m, rng):
    cs, tids = range8_cs(m, 13, True)
    cs.allow_evaluator(m.arith.UIntXAddGate.make_evaluator(16))
    a = m.w.UInt16.allocate_checked(cs, 0x1234, tids)
    b = m.w.UInt16.allocate_checked(cs, 0x5678, tids)
    d, brw = a.sub(b)
    s, carry = a.add(b)
    return _finish(cs, [o.get_witness() for o in (d, brw, s, carry)],
                   [(0x1234 - 0x5678) % (1 << 16), True, 0x1234 + 0x5678,
                    False])


def uint64_limb_ops(m, rng):
    cs, tids = range8_cs(m, 13, True)
    U, Boolean = m.w.UInt64, m.w.Boolean
    av, bv = 0xFFFFFFFF_FFFFFFF0, 0x20
    a, b = U.allocate_checked(cs, av, tids), U.allocate_checked(cs, bv, tids)
    s, ovf = a.add(b)
    d, brw = b.sub(a)
    t = Boolean.allocate(cs, True)
    le = a.to_le_bytes(tids)
    out = [s, ovf, d, brw, a.select(t, b),
           a.equals(U.allocate_checked(cs, av, tids)), a.equals(b),
           U.allocate_constant(cs, 0).is_zero(), a.is_zero(),
           a.mask(Boolean.allocate(cs, False))]
    out = [o.get_witness() for o in out]
    out += [[x.get_witness() for x in le],
            U.from_le_bytes(cs, le, tids).get_witness()]
    want = [(av + bv) % (1 << 64), True, (bv - av) % (1 << 64), True, av,
            True, False, True, False, 0, list(av.to_bytes(8, "little")), av]
    return _finish(cs, out, want)


def multilimb_byte_views(m, rng):
    cs, tids = range8_cs(m, 13, True)
    w = m.w
    v = int.from_bytes(rng.bytes(32), "little")
    a = w.UInt256.allocate_checked(cs, v, tids)
    le = a.to_le_bytes(tids)
    limbs = a.decompose_into_u32_limbs()
    wv = int.from_bytes(rng.bytes(64), "little")
    b = w.UInt512.allocate_checked(cs, wv, tids)
    out = [[x.get_witness() for x in le],
           [x.get_witness() for x in a.to_be_bytes(tids)],
           w.UInt256.from_le_bytes(cs, le, tids).get_witness(),
           [x.get_witness() for x in limbs],
           w.UInt256.from_u32_limbs(cs, limbs).get_witness(),
           b.to_low().get_witness(), b.to_high().get_witness()]
    want = [list(v.to_bytes(32, "little")), list(v.to_bytes(32, "big")), v,
            [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)], v,
            wv % (1 << 256), wv >> 256]
    return _finish(cs, out, want)


def _u256(rng):
    return int.from_bytes(rng.bytes(32), "little")


def widening_mul(m, rng):
    cs, tids = range8_cs(m, 14, False)
    a_v, b_v = _u256(rng), _u256(rng)
    a = m.w.UInt256.allocate_checked(cs, a_v, tids)
    b = m.w.UInt256.allocate_checked(cs, b_v, tids)
    return _finish(cs, [a.widening_mul(b, tids).get_witness()], [a_v * b_v])


def widening_mul_corrupted(m, rng):
    """tests/test_wide_uints.py::test_widening_mul_corrupted_fails."""
    cs, tids = range8_cs(m, 14, False)
    a = m.w.UInt256.allocate_checked(cs, 3, tids)
    b = m.w.UInt256.allocate_checked(cs, 5, tids)
    wide = a.widening_mul(b, tids)
    idx = int(m.places.index_of(np.asarray([wide.limbs[0].variable]))[0])

    def corrupt(cs):
        cs.resolver.values[idx] ^= 1
    return _finish(cs, [wide.get_witness()], [15], True, corrupt)


def div_rem(m, rng):
    cs, tids = range8_cs(m, 14, False)
    a_v, b_v = _u256(rng), _u256(rng) >> 130
    a = m.w.UInt256.allocate_checked(cs, a_v, tids)
    b = m.w.UInt256.allocate_checked(cs, b_v, tids)
    q, r = a.div_rem(b, tids)
    return _finish(cs, [q.get_witness(), r.get_witness()],
                   [a_v // b_v, a_v % b_v])


def misc_ops(m, rng):
    cs, tids = range8_cs(m, 14, False)
    U, Boolean = m.w.UInt256, m.w.Boolean
    a_v = _u256(rng)
    a, b = U.allocate_checked(cs, a_v, tids), U.allocate_checked(cs, a_v, tids)
    c = U.allocate_checked(cs, a_v ^ 1, tids)
    out = [cs.get_value(a.equals(b).variable), cs.get_value(a.equals(c).variable),
           cs.get_value(a.is_odd(tids).variable), a.div2(tids).get_witness()]
    t, f = Boolean.allocate(cs, True), Boolean.allocate(cs, False)
    out += [a.mask(t).get_witness(), a.mask(f).get_witness(),
            a.mask_negated(f).get_witness()]
    return _finish(cs, out, [1, 0, a_v & 1, a_v >> 1, a_v, 0, a_v])


def blake2s_build(m, data):
    """tests/test_blake2s_gadget.py:build."""
    g = m.gates
    cs = m.cs.ConstraintSystem(m.cs.CSGeometry(60, 0, 4, 4), 1 << 15,
                               m.cs.CSConfig.dev())
    cs.allow_lookup(m.cs.LookupParameters.specialized_with_table_id_as_constant(
        width=4, num_repetitions=8, share_table_id=True))
    for gate in (g.ConstantsAllocatorGate, g.FmaGate, g.NopGate):
        cs.allow_gate(gate)
    cs.allow_gate(g.ReductionGate, params=4)
    tids = m.sha.add_sha256_tables(cs)
    in_vars = m.uints.allocate_u8_checked_batch(
        cs, np.frombuffer(data, np.uint8).astype(np.uint64), tids)
    return cs, m.b2s.blake2s(cs, in_vars, tids)


def blake2s(length):
    def case(m, rng):
        data = bytes(rng.integers(0, 256, length, dtype=np.uint8))
        cs, out = blake2s_build(m, data)
        digest = bytes(int(cs.get_value(int(v))) for v in out)
        return _finish(cs, [digest],
                       [hashlib.blake2s(data, digest_size=32).digest()])
    return case


def _nn(m, cs, modulus, *vals):
    params = m.nn.NonNativeParams.for_modulus(modulus)
    return params, [m.nn.NonNativeField.allocate_checked(cs, params, v)
                    for v in vals]


def _bn(rng):
    return int.from_bytes(rng.bytes(31), "big") % BN254


def non_native_mul_add(m, rng):
    cs, _ = wrappers_cs(m, with_tables=False)
    a_val, b_val = _bn(rng), _bn(rng)
    _, (a, b) = _nn(m, cs, BN254, a_val, b_val)
    return _finish(cs, [a.mul(b).get_witness(), a.add(b).get_witness()],
                   [a_val * b_val % BN254, (a_val + b_val) % BN254])


def non_native_corruption(m, rng):
    """tests/test_non_native.py::test_non_native_corruption_detected."""
    cs, _ = wrappers_cs(m, with_tables=False)
    _, (a, b) = _nn(m, cs, BN254, 12345, 67890)
    c = a.mul(b)

    def corrupt(cs):
        cs.resolver.values[c.limbs[2]] ^= 1
    return _finish(cs, [c.get_witness()], [12345 * 67890], True, corrupt)


def secp256k1_point_ops(m, rng):
    G2 = (0xC6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5,
          0x1AE168FEA63DC339A3C58419466CEAEEF7F632653266D0E1236431A950CFE52A)
    G3 = (0xF9308A019258C31049344F85F89D5229B531C845836F99B08601F113BCE036F9,
          0x388F7B0F632DE8140FE337E62A37F3566500A99934C2231B6CB9FD7584B8E672)
    params = m.nn.NonNativeParams.for_modulus(SECP_P)
    cs, _ = wrappers_cs(m, with_tables=False, max_trace=1 << 15)
    G = m.cv.SWAffinePoint.allocate_checked(cs, params, GX, GY, 0, 7)
    g2 = G.double()
    g3 = g2.add_unequal(G)
    return _finish(cs, [(g2.x.get_witness(), g2.y.get_witness()),
                        (g3.x.get_witness(), g3.y.get_witness())], [G2, G3])


def non_native_sub_div_canonical(m, rng):
    cs, _ = wrappers_cs(m, with_tables=False)
    a_val, b_val = _bn(rng), _bn(rng)
    params, (a, b) = _nn(m, cs, BN254, a_val, b_val)
    out = [a.sub(b).get_witness(), b.sub(a).get_witness(),
           a.neg().get_witness(), a.div(b).get_witness(),
           b.inverse().get_witness()]
    a.enforce_canonical()
    a.equals_canonical(m.nn.NonNativeField.allocate_checked(cs, params, a_val))
    want = [(a_val - b_val) % BN254, (b_val - a_val) % BN254, -a_val % BN254,
            a_val * pow(b_val, -1, BN254) % BN254, pow(b_val, -1, BN254)]
    return _finish(cs, out, want)


def non_native_div_corruption(m, rng):
    cs, _ = wrappers_cs(m, with_tables=False)
    _, (a, b) = _nn(m, cs, BN254, 999, 77)
    d = a.div(b)

    def corrupt(cs):
        cs.resolver.values[d.limbs[0]] ^= 1
    return _finish(cs, [d.get_witness()], [999 * pow(77, -1, BN254) % BN254],
                   True, corrupt)


def non_native_parity_helpers(m, rng):
    cs, _ = wrappers_cs(m, with_tables=False)
    a_val = _bn(rng)
    _, (a, z) = _nn(m, cs, BN254, a_val, 0)
    t, f = m.w.Boolean.allocate(cs, True), m.w.Boolean.allocate(cs, False)
    out = [a.double().get_witness(), a.square().get_witness(),
           a.negated().get_witness() % BN254,
           a.add(a).sub(a).normalize().get_witness(),
           cs.get_value(a.is_zero()), cs.get_value(z.is_zero()),
           a.mask(t.variable).get_witness(), a.mask(f.variable).get_witness(),
           a.mask_negated(f.variable).get_witness(),
           a.allocate_inverse_or_zero().get_witness(),
           z.allocate_inverse_or_zero().get_witness()]
    want = [2 * a_val % BN254, a_val * a_val % BN254, -a_val % BN254, a_val,
            0, 1, a_val, 0, a_val, pow(a_val, -1, BN254), 0]
    return _finish(cs, out, want)


def non_native_inverse_or_zero_corruption(m, rng):
    cs, _ = wrappers_cs(m, with_tables=False)
    _, (a,) = _nn(m, cs, BN254, 424242)
    inv = a.allocate_inverse_or_zero()

    def corrupt(cs):
        cs.resolver.values[inv.limbs[0]] ^= 1
    return _finish(cs, [inv.get_witness()], [pow(424242, -1, BN254)], True,
                   corrupt)


def projective_complete_add_edge_cases(m, rng):
    params = m.nn.NonNativeParams.for_modulus(SECP_P)
    cs, _ = wrappers_cs(m, with_tables=False, max_trace=1 << 16)
    Proj = m.cv.SWProjectivePoint
    G = Proj.from_affine(m.cv.SWAffinePoint.allocate_checked(
        cs, params, GX, GY, 0, 7))

    def affine(p):
        pt, flag = p.convert_to_affine_or_default((0, 0))
        return (pt.x.get_witness(), pt.y.get_witness(),
                int(cs.resolver.get_value(flag)))

    g2 = G.add(G)
    zero = Proj.zero(cs, params, 0, 7)
    out = [affine(g2), affine(g2.add(G)), affine(G.add(G.negate())),
           affine(zero.add(G)), affine(zero.add(zero))]
    w2 = m.cv.host_ec_add((GX, GY), (GX, GY), 0, SECP_P)
    w3 = m.cv.host_ec_add(w2, (GX, GY), 0, SECP_P)
    want = [(*w2, 0), (*w3, 0), (0, 0, 1), (GX, GY, 0), (0, 0, 1)]
    return _finish(cs, out, want)


def lazy_limb_arithmetic(m, rng):
    cs, _ = wrappers_cs(m, with_tables=False)
    vals = [_bn(rng) for _ in range(6)]
    _, els = _nn(m, cs, BN254, *vals)
    rows_before = cs.next_available_row
    lazy = m.nn.NonNativeFieldLazy.add_many_lazy(els)
    lazy = lazy.lazy_double().lazy_add(els[0])
    rows_after = cs.next_available_row
    red = lazy.normalize()
    prod = red.mul(els[1])
    want = (2 * sum(vals) + vals[0]) % BN254

    def corrupt(cs):
        cs.resolver.values[red.limbs[0]] ^= 1
    return _finish(cs, [rows_after - rows_before,
                        lazy.get_witness() % BN254, red.get_witness(),
                        prod.get_witness()],
                   [0, want, want, want * vals[1] % BN254], True, corrupt)


CASES = {
    # tests/test_wrappers.py
    "num_boolean": (num_boolean, 31),
    "uints": (uints, 31),
    "uint_range_check": (uint_range_check, 31),
    "circuit_queue": (circuit_queue, 31),
    "multilimb_uints": (multilimb_uints, 31),
    "full_state_queue": (full_state_queue, 32),
    "sponge_optimizer_queues": (sponge_optimizer_queues, 33),
    # tests/test_wrapper_parity.py
    "num_linear_combination_and_dot_product": (
        num_linear_combination_and_dot_product, 23),
    "num_fma_inverse_swap_mask": (num_fma_inverse_swap_mask, 23),
    "num_conditional_enforce_bites": (num_conditional_enforce_bites, 23),
    "boolean_parity_ops": (boolean_parity_ops, 23),
    "boolean_conditional_enforce_bites": (
        boolean_conditional_enforce_bites, 23),
    "uint32_fma_with_carry_and_mul": (uint32_fma_with_carry_and_mul, 24),
    "uint32_div_and_views": (uint32_div_and_views, 23),
    "uint32_div_by_constant_bad_remainder": (
        uint32_div_by_constant_bad_remainder, 23),
    "uint16_generic_sub": (uint16_generic_sub, 23),
    "uint64_limb_ops": (uint64_limb_ops, 23),
    "multilimb_byte_views": (multilimb_byte_views, 25),
    # tests/test_wide_uints.py
    "widening_mul": (widening_mul, 17),
    "widening_mul_corrupted": (widening_mul_corrupted, 17),
    "div_rem": (div_rem, 18),
    "misc_ops": (misc_ops, 19),
    # tests/test_blake2s_gadget.py
    "blake2s_one_block": (blake2s(30), 9),
    "blake2s_two_blocks": (blake2s(100), 10),
    # tests/test_non_native.py (not its two slow cases)
    "non_native_mul_add_bn254": (non_native_mul_add, 17),
    "non_native_corruption": (non_native_corruption, 17),
    "secp256k1_point_ops": (secp256k1_point_ops, 17),
    "non_native_sub_div_canonical": (non_native_sub_div_canonical, 18),
    "non_native_div_corruption": (non_native_div_corruption, 17),
    "non_native_parity_helpers": (non_native_parity_helpers, 19),
    "non_native_inverse_or_zero_corruption": (
        non_native_inverse_or_zero_corruption, 17),
    "projective_complete_add_edge_cases": (
        projective_complete_add_edge_cases, 17),
    "lazy_limb_arithmetic": (lazy_limb_arithmetic, 20),
}


@pytest.mark.parametrize("name", list(CASES))
def test_gadget_case_matches_reference(name):
    fn, seed = CASES[name]
    built = {}
    for pkg in ("boojum_tpu", "boojum_tpu_torch"):
        m = _mods(pkg)
        cs, out, want, ok, corrupt = fn(m, np.random.default_rng(seed))
        cs.pad_and_shrink()
        built[pkg] = (m, cs, out, want, ok, corrupt)
    ref_m, ref_cs, ref_out, _, ref_ok, _ = built["boojum_tpu"]
    m, cs, out, want, ok, corrupt = built["boojum_tpu_torch"]
    assert out == ref_out
    assert out == want  # what the JAX test asserts
    assert cs.final_trace_len == ref_cs.final_trace_len
    assert np.array_equal(cs.resolver.values, ref_cs.resolver.values)
    sb, ref_sb = m.setup.create_base_setup(cs), \
        ref_m.setup.create_base_setup(ref_cs)
    for field in SB_ARRAYS:
        assert np.array_equal(getattr(sb, field), getattr(ref_sb, field)), \
            field
    for field in SB_FIELDS:
        assert getattr(sb, field) == getattr(ref_sb, field), field
    assert cs.check_if_satisfied(verbose=False) is ok
    assert ref_cs.check_if_satisfied(verbose=False) is ok
    if corrupt is not None:
        corrupt(cs)
        assert not cs.check_if_satisfied(verbose=False)


def test_byte_range_check_rejects_oversize():
    """tests/test_wide_uints.py::test_byte_range_check_rejects_oversize."""
    m = _mods("boojum_tpu_torch")
    cs, tids = range8_cs(m, 14, False)
    v = cs.alloc_variable_with_value(300)
    with pytest.raises(KeyError):
        m.w.byte_range_check(cs, [v], tids)


# ---------------------------------------------------------------------------
# cs/gates/testing.py (tests/test_gate_testing_tools.py)
# ---------------------------------------------------------------------------


def _evaluator_circuit(m, which):
    if which == "small":
        from tests.torch_small_circuit import build_small_circuit
        return build_small_circuit(m.__name__, np.random.default_rng(11),
                                   n_fma=4)
    if which == "sha256":
        data = bytes(np.random.default_rng(0).integers(0, 256, 8,
                                                       dtype=np.uint8))
        build = importlib.import_module(
            "tests.test_sha256" if m.__name__ == "boojum_tpu"
            else m.__name__ + ".gadgets.sha256").build_sha256_circuit
        return build(data)[0]
    cs_mod = importlib.import_module(m.__name__ + ".cs")
    geom = cs_mod.CSGeometry(num_columns_under_copy_permutation=132,
                             num_witness_columns=0, num_constant_columns=8,
                             max_allowed_constraint_degree=8)
    cs = cs_mod.ConstraintSystem(geom, 1 << 6, cs_mod.CSConfig.dev())
    importlib.import_module(m.__name__ + ".gadgets.poseidon2_circuit") \
        .allow_poseidon2_gates(cs, flattened=True)
    importlib.import_module(m.__name__ + ".gadgets.recursion.primitives") \
        .allow_poseidon_gates(cs, flattened=True)
    return cs


def _evaluator_rows(cs, run):
    rows = []
    for ev in list(cs.evaluators_general) + list(cs.evaluators_specialized):
        if ev.num_quotient_terms > 0:
            run(ev)
            rows.append((ev.name, ev.num_quotient_terms, ev.num_variables,
                         ev.num_witnesses, ev.num_constants,
                         ev.max_constraint_degree))
    return rows


@pytest.mark.parametrize("which", ["small", "sha256", "poseidon_gates"])
def test_evaluators_pass_the_harness_as_in_reference(which):
    """Every evaluator of the JAX test's circuits passes the port's
    `test_evaluator` with the term counts and widths of the reference's."""
    ref = _evaluator_rows(_evaluator_circuit(
        importlib.import_module("boojum_tpu"), which),
        ref_testing.test_evaluator)
    got = _evaluator_rows(_evaluator_circuit(
        importlib.import_module("boojum_tpu_torch"), which),
        testing.test_evaluator)
    assert got and got == ref


class _Liar(GateEvaluator):
    name = "liar"
    num_variables = 2
    num_quotient_terms = 2
    max_constraint_degree = 1

    def evaluate(self, src, ops):
        return [src.var(0)]  # claims 2, pushes 1


class _Wide(GateEvaluator):
    name = "wide"
    num_variables = 1
    num_quotient_terms = 1
    max_constraint_degree = 1

    def evaluate(self, src, ops):
        return [ops.add(src.var(0), src.var(1))]  # reads past its width


@pytest.mark.parametrize("ev,match", [(_Liar, "claims 2 terms"),
                                      (_Wide, "beyond claimed width")])
def test_harness_catches_a_lying_evaluator(ev, match):
    with pytest.raises(AssertionError, match=match):
        testing.test_evaluator(ev())


def test_placeholder_asserts():
    testing.assert_not_placeholder(places.variable(3))
    testing.assert_no_placeholders([places.variable(0), places.witness(1)])
    assert places.PLACEHOLDER == ref_places.PLACEHOLDER
    with pytest.raises(AssertionError):
        testing.assert_not_placeholder(places.PLACEHOLDER)
    with pytest.raises(AssertionError):
        testing.assert_no_placeholders([places.variable(0),
                                        places.PLACEHOLDER])


# ---------------------------------------------------------------------------
# utils/native.py (tests/test_native.py): both packages build the same
# source; the port's library lies in boojum_tpu_torch/_build/
# ---------------------------------------------------------------------------


def _edge_and_random(n=4096, seed=11):
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 2, P - 1, P - 2, 0xFFFF_FFFF, 0x1_0000_0000,
                      P >> 1, (1 << 63) % P, 0xFFFF_FFFE_0000_0002 % P],
                     dtype=np.uint64)
    return np.concatenate([edges, rng.integers(0, P, size=n,
                                               dtype=np.uint64)])


def test_native_builds_where_the_reference_does():
    """The port builds the library where the reference does (g++ here), in
    its own build directory; its results are then npgl's, entry point by
    entry point, below."""
    assert native.available() == ref_native.available()
    if native.available():
        assert "_build" in native._OUT and "native" not in \
            native._OUT.split("boojum_tpu_torch")[1]


@pytest.mark.parametrize("entry", ["mul", "add", "batch_inv", "powers"])
def test_native_matches_exact_and_reference(entry):
    """Each entry point against exact Python-int arithmetic and the
    reference's (native or numpy, whichever each package runs)."""
    a = _edge_and_random(seed=1)
    b = _edge_and_random(seed=2)[::-1].copy()
    if entry == "powers":
        for base in (7, P - 1, 0x185629DCDA58878C, 1):
            want = np.array([pow(base, i, P) for i in range(257)], np.uint64)
            got = native.powers(base, 257) if native.available() \
                else np.asarray([pow(base, i, P) for i in range(257)],
                                np.uint64)
            assert np.array_equal(got, want)
        return
    if entry == "batch_inv":
        a = a[a != 0]
        exact = np.array([pow(int(x), P - 2, P) for x in a], np.uint64)
        got, ref = npgl.batch_inv(a), ref_npgl.batch_inv(a)
        if native.available():
            assert np.array_equal(native.batch_inv(a), exact)
    else:
        op = (lambda x, y: x * y) if entry == "mul" else (lambda x, y: x + y)
        exact = np.array([op(int(x), int(y)) % P for x, y in zip(a, b)],
                         np.uint64)
        got, ref = getattr(npgl, entry)(a, b), getattr(ref_npgl, entry)(a, b)
        if native.available():
            assert np.array_equal(getattr(native, entry)(a, b), exact)
    assert np.array_equal(got, exact)
    assert np.array_equal(ref, exact)


def test_native_agrees_with_numpy_paths():
    """npgl's numpy kernels and the native ones agree on large vectors (the
    port's npgl takes either)."""
    rng = np.random.default_rng(99)
    a = rng.integers(0, P, size=1 << 14, dtype=np.uint64)
    b = rng.integers(0, P, size=1 << 14, dtype=np.uint64)
    hi, lo = npgl._mul_wide(a, b)
    np_mul = npgl._reduce128(hi, lo)
    assert np.array_equal(npgl.mul(a, b), np_mul)
    if native.available():
        assert np.array_equal(native.mul(a, b), np_mul)
