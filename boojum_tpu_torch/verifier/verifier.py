# Copied from boojum_tpu/verifier/verifier.py.
"""Plain (host-side) proof verifier.

Reference behavior: Verifier::verify (src/cs/implementations/verifier.rs:888)
— transcript mirror of the prover (SURVEY §3.4): caps/publics → β,γ →
[lookup β̂,γ̂] → stage-2 cap → α → quotient cap → z → claimed evaluations →
DEEP challenge → FRI caps/challenges/final monomials → PoW → query indices;
then (a) the quotient identity at z re-derived with the SAME gate evaluators
run over extension scalars (the generic-evaluator payoff), (b) lookup
log-derivative sum check at 0, (c) per-query DEEP recomputation, FRI fold
checks and Merkle path verification against caps.

Pure sequential host code (ints) — the verifier must be cheap and exact.
It launches nothing on a device and takes no ``device``.
"""

from __future__ import annotations

from ..cs.gates.base import Ext2Ops, TraceView
from ..cs.setup import non_residues_for_copy_permutation
from ..field import extension as ext2
from ..field.goldilocks import (MULTIPLICATIVE_GENERATOR, ORDER,
                                domain_generator)
from ..hash.merkle import AlgebraicMerkleTree, BytesMerkleTree
from ..hash import poseidon, poseidon2, sponge
from ..ntt import ntt
from ..transcript import make_transcript
from ..prover import pow as pow_mod
from ..prover.fri import compute_fri_schedule
from ..prover.proof import Proof, VerificationKey
from ..prover.prover import _BoolsBuffer, _u64_from_lsb

P = ORDER

E_ZERO = (0, 0)
E_ONE = (1, 0)

import threading as _threading

# per-thread failure reason (debug aid): a verifying service may run
# concurrent verifications; module attribute access (`verifier.LAST_FAILURE`)
# resolves through __getattr__ below to this thread's value
_tls = _threading.local()


def _fail(reason: str) -> bool:
    _tls.last_failure = reason
    return False


def last_failure():
    """Reason string of this THREAD's most recent verification failure."""
    return getattr(_tls, "last_failure", None)


def __getattr__(name):
    if name == "LAST_FAILURE":
        return last_failure()
    raise AttributeError(name)


def _p2flat():
    from ..cs.gates.poseidon2_gate import Poseidon2FlattenedEvaluator
    return Poseidon2FlattenedEvaluator()


def _pflat():
    from ..cs.gates.poseidon_gate import PoseidonFlattenedEvaluator
    return PoseidonFlattenedEvaluator()


def _registry():
    from ..cs.gates import arith as ga
    from ..cs.gates import simple as g
    return {
        "nop": lambda n: g.NopEvaluator(),
        "lookup_formal": lambda p: g.LookupMarkerEvaluator(p[0], p[1] > 0),
        "public_input": lambda n: g.PublicInputEvaluator(),
        "constants_allocator": lambda n: g.ConstantsAllocatorEvaluator(),
        "fma": lambda n: g.FmaEvaluator(),
        "boolean": lambda n: g.BooleanEvaluator(),
        "selection": lambda n: g.SelectionEvaluator(),
        "zero_check": lambda n: g.ZeroCheckEvaluator(bool(n)),
        "boolean_bounded": g.BoundedBooleanEvaluator,
        "constants_allocator_bounded": lambda n: \
            g.BoundedConstantsAllocatorEvaluator(int(n)),
        "reduction": g.ReductionEvaluator,
        "parallel_selection": g.ParallelSelectionEvaluator,
        "conditional_swap": g.ConditionalSwapEvaluator,
        "dot_product": g.DotProductEvaluator,
        "quadratic_combination": g.QuadraticCombinationEvaluator,
        "reduction_by_powers": g.ReductionByPowersEvaluator,
        "u32_add": lambda n: ga.U32AddEvaluator(),
        "u32_sub": lambda n: ga.U32SubEvaluator(),
        "uintx_add": ga.UIntXAddEvaluator,
        "fma_ext": lambda n: ga.FmaExtEvaluator(),
        "simple_nonlinearity": ga.SimpleNonlinearityEvaluator,
        "u32_tri_add_carry": lambda n: ga.U32TriAddCarryEvaluator(),
        "u8x4_fma": lambda n: ga.U8x4FMAEvaluator(),
        "poseidon2_flattened": lambda n: _p2flat(),
        "poseidon_flattened": lambda n: _pflat(),
    }


def build_evaluators(specs):
    reg = _registry()
    out = []
    for (name, params) in specs:
        if name.startswith("matrix_mul") or (
                isinstance(params, (tuple, list)) and len(params) == 2
                and isinstance(params[1], (tuple, list))):
            # a (n, matrix) spec — MatrixMultiplication under any gate name
            from ..cs.gates.arith import MatrixMulEvaluator
            ev = MatrixMulEvaluator(params)
            ev.name = name
            out.append(ev)
        elif name.startswith("constants_as_constraint"):
            from ..cs.gates.simple import ConstantsAsConstraintEvaluator
            out.append(ConstantsAsConstraintEvaluator(tuple(params or ())))
        elif name in reg:
            out.append(reg[name](params))
        else:
            base = name.rsplit("_", 1)[0]
            out.append(reg[base](int(name.rsplit("_", 1)[1])))
    return out


def verify(vk: VerificationKey, proof: Proof, transcript_kind: str = "poseidon2",
           hasher: str = "poseidon2", expected_proof_config=None,
           _skip_gate_identity: bool = False,
           _identity_only: bool = False) -> bool:
    """Top-level verification entry. Never raises on malformed proofs —
    structural damage returns False (the reference also returns bool;
    services verify untrusted proofs, so exceptions here are a DoS vector).
    """
    try:
        return _verify_inner(vk, proof, transcript_kind, hasher,
                             expected_proof_config, _skip_gate_identity,
                             _identity_only)
    except Exception as e:  # malformed structure: wrong lengths/types/etc.
        return _fail(f"malformed proof ({type(e).__name__}: {e})")


def _verify_inner(vk: VerificationKey, proof: Proof, transcript_kind: str,
                  hasher: str, expected_proof_config,
                  _skip_gate_identity: bool, _identity_only: bool) -> bool:
    fixed = vk.fixed_parameters

    # -- proof_config is attacker-controlled: pin it down --------------------
    # (reference verifier.rs:898-922 cross-checks lde factor / cap size vs
    # VK; security_level/pow_bits are additionally pinned when the VK or the
    # caller provides them)
    pc = proof.proof_config
    if pc.fri_lde_factor != fixed.fri_lde_factor:
        return _fail("proof fri_lde_factor differs from VK")
    if pc.merkle_tree_cap_size != fixed.cap_size:
        return _fail("proof merkle cap size differs from VK")
    if fixed.security_level is not None and (
            pc.security_level != fixed.security_level
            or pc.pow_bits != fixed.pow_bits):
        return _fail("proof security parameters differ from VK pinned values")
    if expected_proof_config is not None:
        want = (expected_proof_config.fri_lde_factor,
                expected_proof_config.merkle_tree_cap_size,
                expected_proof_config.security_level,
                expected_proof_config.pow_bits)
        got = (pc.fri_lde_factor, pc.merkle_tree_cap_size,
               pc.security_level, pc.pow_bits)
        if want != got:
            return _fail("proof config differs from expected_proof_config")
    n = fixed.domain_size
    log_n = n.bit_length() - 1
    qd = fixed.quotient_degree
    fri_lde = fixed.fri_lde_factor
    cap_size = fixed.cap_size
    geometry = fixed.geometry
    lp = fixed.lookup_parameters
    omega = domain_generator(log_n)
    evaluators = build_evaluators(fixed.evaluator_specs)

    num_var = fixed.num_variable_polys
    num_wit = fixed.num_witness_polys
    num_const = fixed.num_constant_polys
    num_mult = fixed.num_multiplicity_polys
    num_sigma = num_var
    num_table = lp.lookup_width() + 1 if lp.lookup_is_allowed else 0
    num_lookup_subargs = lp.num_sublookup_arguments_for_geometry(geometry)
    num_intermediates = max(-(-num_var // qd) - 1, 0)

    # -- structural checks (reference verifier.rs:1860,2427 analogues) ------
    for cap in (vk.setup_merkle_tree_cap, proof.witness_oracle_cap,
                proof.stage_2_oracle_cap, proof.quotient_oracle_cap,
                proof.fri_base_oracle_cap,
                *proof.fri_intermediate_oracles_caps):
        if len(cap) != cap_size:
            return _fail("oracle cap length != cap_size")
    if len(proof.values_at_z_omega) != 1:
        return _fail("values_at_z_omega count mismatch")
    if len(proof.values_at_0) != (num_lookup_subargs + num_mult
                                  if lp.lookup_is_allowed else 0):
        return _fail("values_at_0 count mismatch")
    if len(proof.final_fri_monomials) != 2 or \
            len(proof.final_fri_monomials[0]) != len(proof.final_fri_monomials[1]):
        return _fail("final fri monomials malformed")

    # -- transcript mirror --------------------------------------------------
    transcript = make_transcript(transcript_kind)
    transcript.witness_merkle_tree_cap(vk.setup_merkle_tree_cap)
    if len(proof.public_inputs) != len(fixed.public_inputs_locations):
        return _fail("public inputs count mismatch")
    transcript.witness_field_elements(proof.public_inputs)
    transcript.witness_merkle_tree_cap(proof.witness_oracle_cap)
    beta = tuple(transcript.get_multiple_challenges(2))
    gamma = tuple(transcript.get_multiple_challenges(2))
    lookup_beta = lookup_gamma = E_ZERO
    if lp.lookup_is_allowed:
        lookup_beta = tuple(transcript.get_multiple_challenges(2))
        lookup_gamma = tuple(transcript.get_multiple_challenges(2))
    transcript.witness_merkle_tree_cap(proof.stage_2_oracle_cap)
    alpha = tuple(transcript.get_multiple_challenges(2))
    transcript.witness_merkle_tree_cap(proof.quotient_oracle_cap)
    z_pt = tuple(transcript.get_multiple_challenges(2))
    for v in proof.values_at_z:
        transcript.witness_field_elements([v[0], v[1]])
    transcript.witness_field_elements([proof.values_at_z_omega[0][0],
                                       proof.values_at_z_omega[0][1]])
    for v in proof.values_at_0:
        transcript.witness_field_elements([v[0], v[1]])

    # -- parse values_at_z by the prover's order ----------------------------
    vals = [tuple(v) for v in proof.values_at_z]
    idx = 0

    def take(k):
        nonlocal idx
        out = vals[idx:idx + k]
        idx += k
        return out

    v_vars = take(num_var)
    v_wits = take(num_wit)
    v_consts = take(num_const)
    v_sigmas = take(num_sigma)
    v_z = take(1)[0]
    v_inter = take(num_intermediates)
    v_mults = take(num_mult) if lp.lookup_is_allowed else []
    v_a = take(num_lookup_subargs) if lp.lookup_is_allowed else []
    v_b = take(num_mult) if lp.lookup_is_allowed else []
    v_tables = take(num_table) if lp.lookup_is_allowed else []
    v_quotient = take(qd)
    if idx != len(vals):
        return _fail("values_at_z count mismatch")
    v_z_omega = tuple(proof.values_at_z_omega[0])

    # -- alpha powers, same partition as the prover -------------------------
    total_lookup_terms = num_lookup_subargs + num_mult
    spec_layout = fixed.gate_spec_layout or []
    spec_evaluators = build_evaluators(fixed.specialized_evaluator_specs or [])
    total_specialized_terms = sum(
        ev.num_quotient_terms * reps
        for ev, (_, _, reps) in zip(spec_evaluators, spec_layout))
    total_general_terms = sum(ev.num_quotient_terms * ev.num_repetitions(geometry)
                              for ev in evaluators)
    total_terms = (total_lookup_terms + total_specialized_terms
                   + total_general_terms + 2 + num_intermediates)
    alpha_pows = [E_ONE]
    for _ in range(total_terms - 1):
        alpha_pows.append(ext2.s2_mul(alpha_pows[-1], alpha))
    lookup_alphas = alpha_pows[:total_lookup_terms]
    specialized_alphas = alpha_pows[total_lookup_terms:
                                    total_lookup_terms
                                    + total_specialized_terms]
    general_alphas = alpha_pows[total_lookup_terms + total_specialized_terms:
                                total_lookup_terms + total_specialized_terms
                                + total_general_terms]
    remaining_alphas = alpha_pows[total_lookup_terms + total_specialized_terms
                                  + total_general_terms:]

    # -- recompute quotient identity at z -----------------------------------
    rhs = E_ZERO
    gamma_pows = [E_ONE]
    if lp.lookup_is_allowed:
        width = lp.lookup_width()
        for _ in range(width):
            gamma_pows.append(ext2.s2_mul(gamma_pows[-1], lookup_gamma))
        it = iter(lookup_alphas)
        if lp.is_specialized:
            pw = lp.specialized_columns_per_repetition()
            base_off = geometry.num_columns_under_copy_permutation
            sub_term = E_ONE  # A·agg − 1 (active on every row)
        else:
            # general-purpose (reference verifier.rs:1366): A·agg − sel,
            # sel = marker's (evaluator 0) selector path product at z
            pw = lp.columns_per_subargument()
            base_off = 0
            sub_term = E_ONE
            for k, bit in enumerate(fixed.selector_paths[0]):
                c = v_consts[k]
                sub_term = ext2.s2_mul(sub_term,
                                       c if bit else ext2.s2_sub(E_ONE, c))
        for rep in range(num_lookup_subargs):
            agg = lookup_beta
            for i in range(pw):
                agg = ext2.s2_add(agg, ext2.s2_mul(gamma_pows[i],
                                                   v_vars[base_off + rep * pw + i]))
            if lp.id_in_constant:
                tid_cols = fixed.table_ids_column_idxes
                tid_at_z = v_consts[tid_cols[min(rep, len(tid_cols) - 1)]]
                agg = ext2.s2_add(agg, ext2.s2_mul(gamma_pows[width], tid_at_z))
            term = ext2.s2_sub(ext2.s2_mul(v_a[rep], agg), sub_term)
            rhs = ext2.s2_add(rhs, ext2.s2_mul(term, next(it)))
        agg_t = lookup_beta
        for i in range(num_table):
            agg_t = ext2.s2_add(agg_t, ext2.s2_mul(gamma_pows[i], v_tables[i]))
        term = ext2.s2_sub(ext2.s2_mul(v_b[0], agg_t), v_mults[0])
        rhs = ext2.s2_add(rhs, ext2.s2_mul(term, next(it)))

    # specialized gates at z: every-row relations, no selector
    spec_it = iter(specialized_alphas)
    lookup_spec_cols = lp.total_specialized_lookup_variable_columns() \
        if lp.is_specialized else 0
    for ev, (_, sstart, sreps) in zip(spec_evaluators, spec_layout):
        base = geometry.num_columns_under_copy_permutation + lookup_spec_cols \
            + sstart
        for rep in range(sreps):
            cols = [v_vars[base + rep * ev.num_variables + i]
                    for i in range(ev.num_variables)]
            for term in ev.evaluate(TraceView(cols, [], []), Ext2Ops):
                a = next(spec_it)
                rhs = ext2.s2_add(rhs, ext2.s2_mul(term, a))

    # general gates at z
    gen_it = iter(general_alphas)
    for ev_idx, ev in enumerate(evaluators):
        if ev.num_quotient_terms == 0:
            continue
        path = fixed.selector_paths[ev_idx]
        sel = E_ONE
        for k, bit in enumerate(path):
            c = v_consts[k]
            sel = ext2.s2_mul(sel, c if bit else ext2.s2_sub(E_ONE, c))
        src = TraceView(v_vars, v_wits, v_consts[len(path):])
        terms = ev.evaluate_repetitions(src, Ext2Ops, geometry)
        for term in terms:
            a = next(gen_it)
            rhs = ext2.s2_add(rhs, ext2.s2_mul(ext2.s2_mul(term, sel), a))

    # copy permutation at z
    rem_it = iter(remaining_alphas)
    z_pow_n = ext2.s2_pow(z_pt, n)
    vanishing_at_z = ext2.s2_sub(z_pow_n, E_ONE)
    l1_unnorm_at_z = ext2.s2_mul(vanishing_at_z,
                                 ext2.s2_inv(ext2.s2_sub(z_pt, E_ONE)))
    a0 = next(rem_it)
    boundary = ext2.s2_mul(ext2.s2_sub(v_z, E_ONE), l1_unnorm_at_z)
    rhs = ext2.s2_add(rhs, ext2.s2_mul(boundary, a0))

    non_res = non_residues_for_copy_permutation(n, num_var)
    lhs_list = list(v_inter) + [v_z_omega]
    rhs_list = [v_z] + list(v_inter)
    for rel_idx, (lhs_v, rhs_v) in enumerate(zip(lhs_list, rhs_list)):
        a = next(rem_it)
        start = rel_idx * qd
        lhs_acc, rhs_acc = lhs_v, rhs_v
        for j in range(start, min(start + qd, num_var)):
            den = ext2.s2_add(ext2.s2_add((v_vars[j][0], v_vars[j][1]),
                                          ext2.s2_mul(beta, v_sigmas[j])), gamma)
            bx = ext2.s2_mul(beta, ext2.s2_mul((non_res[j], 0), z_pt))
            num_ = ext2.s2_add(ext2.s2_add(v_vars[j], bx), gamma)
            lhs_acc = ext2.s2_mul(lhs_acc, den)
            rhs_acc = ext2.s2_mul(rhs_acc, num_)
        rhs = ext2.s2_add(rhs, ext2.s2_mul(ext2.s2_sub(lhs_acc, rhs_acc), a))

    # quotient(z) · Z_H(z) == rhs
    q_at_z = E_ZERO
    z_pow_nk = E_ONE
    for k in range(qd):
        q_at_z = ext2.s2_add(q_at_z, ext2.s2_mul(z_pow_nk, v_quotient[k]))
        z_pow_nk = ext2.s2_mul(z_pow_nk, z_pow_n)
    if ext2.s2_mul(q_at_z, vanishing_at_z) != rhs and not _skip_gate_identity:
        return _fail("quotient identity at z failed")
    if _identity_only:
        return True

    # lookup sum check at 0: Σ A_i(0) == Σ B(0)
    if lp.lookup_is_allowed:
        a_sum = E_ZERO
        for i in range(num_lookup_subargs):
            a_sum = ext2.s2_add(a_sum, tuple(proof.values_at_0[i]))
        b_sum = E_ZERO
        for i in range(num_mult):
            b_sum = ext2.s2_add(b_sum, tuple(proof.values_at_0[num_lookup_subargs + i]))
        if a_sum != b_sum:
            return _fail("lookup sumcheck at 0 failed")

    # -- DEEP challenges ----------------------------------------------------
    deep = tuple(transcript.get_multiple_challenges(2))
    pub_tuples = {}
    for (col, row), value in zip(fixed.public_inputs_locations,
                                 proof.public_inputs):
        open_at = pow(omega, row, P)
        pub_tuples.setdefault(open_at, []).append((col, int(value)))
    total_ch = len(vals) + 1 + len(proof.values_at_0) + \
        sum(len(s) for s in pub_tuples.values())
    deep_pows = [E_ONE]
    for _ in range(total_ch - 1):
        deep_pows.append(ext2.s2_mul(deep_pows[-1], deep))

    # -- FRI transcript: caps + challenges + final monomials ----------------
    new_pow_bits, num_queries, schedule, final_degree = compute_fri_schedule(
        proof.proof_config.security_level, cap_size,
        proof.proof_config.pow_bits, fri_lde.bit_length() - 1, log_n)
    transcript.witness_merkle_tree_cap(proof.fri_base_oracle_cap)
    fri_challenges = []
    if len(proof.fri_intermediate_oracles_caps) != len(schedule) - 1:
        return _fail("fri intermediate caps count mismatch")
    for i, k in enumerate(schedule):
        if i > 0:
            transcript.witness_merkle_tree_cap(
                proof.fri_intermediate_oracles_caps[i - 1])
        c0 = transcript.get_challenge()
        c1 = transcript.get_challenge()
        fri_challenges.append((c0, c1))
    if len(proof.final_fri_monomials[0]) != final_degree:
        return _fail("final fri monomials length mismatch")
    transcript.witness_field_elements(proof.final_fri_monomials[0])
    transcript.witness_field_elements(proof.final_fri_monomials[1])

    # -- PoW ----------------------------------------------------------------
    if new_pow_bits > 0:
        challenges = transcript.get_multiple_challenges(4)
        check_pow = {"keccak256": pow_mod.verify_keccak256_pow,
                     "poseidon2": pow_mod.verify_poseidon2_pow,
                     }.get(proof.proof_config.pow_hash,
                           pow_mod.verify_blake2s_pow)
        if not check_pow(challenges, new_pow_bits,
                         proof.pow_challenge):
            return _fail("pow grinding check failed")
        transcript.witness_field_elements(
            [proof.pow_challenge & 0xFFFFFFFF, proof.pow_challenge >> 32])

    # -- queries ------------------------------------------------------------
    max_needed_bits = (n * fri_lde).bit_length() - 1
    num_coset_bits = fri_lde.bit_length() - 1
    num_inner_bits = max_needed_bits - num_coset_bits
    bools = _BoolsBuffer(max_needed_bits)
    g = MULTIPLICATIVE_GENERATOR
    full_size = n * fri_lde
    omega_full = domain_generator(full_size.bit_length() - 1)

    if len(proof.queries_per_fri_repetition) != num_queries:
        return _fail("fri query count mismatch")

    verify_path = (AlgebraicMerkleTree.verify_proof_over_cap
                   if hasher in ("poseidon", "poseidon2")
                   else BytesMerkleTree.verify_proof_over_cap)

    def leaf_hash(values):
        if hasher in ("poseidon", "poseidon2"):
            perm = poseidon2.s_permutation if hasher == "poseidon2" \
                else poseidon.s_permutation
            return tuple(sponge.scalar_hash_into_leaf(values, perm))
        else:
            data = b"".join(int(v).to_bytes(8, "little") for v in values)
            return BytesMerkleTree._digest(hasher, data)

    def check_opening(query, cap, leaf_idx, num_leaf_elems):
        if len(query.leaf_elements) != num_leaf_elems:
            return _fail("oracle leaf element count mismatch")
        lh = leaf_hash(query.leaf_elements)
        kwargs = {"permutation": hasher} if hasher in ("poseidon", "poseidon2") \
            else {"algo": hasher}
        return verify_path(query.proof, cap, lh, leaf_idx, **kwargs)

    tree_depth = full_size.bit_length() - 1 - (cap_size.bit_length() - 1)
    for q in proof.queries_per_fri_repetition:
        bits = bools.get_bits(transcript, max_needed_bits)
        inner_idx = _u64_from_lsb(bits[:num_inner_bits])
        coset_idx = _u64_from_lsb(bits[num_inner_bits:])
        leaf_idx = coset_idx * n + inner_idx

        # structural: path depth vs expected tree depth (verifier.rs:2427)
        for oq in (q.witness_query, q.stage_2_query, q.quotient_query,
                   q.setup_query):
            if len(oq.proof) != tree_depth:
                return _fail("oracle merkle path depth mismatch")
        if len(q.fri_queries) != len(schedule):
            return _fail("fri query layer count mismatch")

        num_witness_elems = num_var + num_wit + num_mult
        num_stage2_elems = 2 * (1 + num_intermediates + num_lookup_subargs + num_mult)
        num_setup_elems = num_sigma + num_const + num_table
        if not check_opening(q.witness_query, proof.witness_oracle_cap,
                             leaf_idx, num_witness_elems):
            return _fail("witness oracle opening failed")
        if not check_opening(q.stage_2_query, proof.stage_2_oracle_cap,
                             leaf_idx, num_stage2_elems):
            return _fail("stage2 oracle opening failed")
        if not check_opening(q.quotient_query, proof.quotient_oracle_cap,
                             leaf_idx, 2 * qd):
            return _fail("quotient oracle opening failed")
        if not check_opening(q.setup_query, vk.setup_merkle_tree_cap,
                             leaf_idx, num_setup_elems):
            return _fail("setup oracle opening failed")

        # x coordinate of the query point (flat bitreversed layout)
        flat_idx = coset_idx * n + inner_idx
        log_full = full_size.bit_length() - 1
        rev = int(ntt.bitreverse_indices(log_full)[flat_idx])
        x_q = (g * pow(omega_full, rev, P)) % P

        # recompute the DEEP combination h(x_q)
        w = q.witness_query.leaf_elements
        s2_ = q.stage_2_query.leaf_elements
        qt = q.quotient_query.leaf_elements
        st = q.setup_query.leaf_elements

        sources_z = []
        for i in range(num_var + num_wit):
            sources_z.append((w[i], 0))
        for i in range(num_const):
            sources_z.append((st[num_sigma + i], 0))
        for i in range(num_sigma):
            sources_z.append((st[i], 0))
        sources_z.append((s2_[0], s2_[1]))
        for i in range(num_intermediates):
            sources_z.append((s2_[2 + 2 * i], s2_[3 + 2 * i]))
        if lp.lookup_is_allowed:
            for i in range(num_mult):
                sources_z.append((w[num_var + num_wit + i], 0))
            a_off = 2 * (1 + num_intermediates)
            for i in range(num_lookup_subargs):
                sources_z.append((s2_[a_off + 2 * i], s2_[a_off + 2 * i + 1]))
            b_off = a_off + 2 * num_lookup_subargs
            sources_z.append((s2_[b_off], s2_[b_off + 1]))
            for i in range(num_table):
                sources_z.append((st[num_sigma + num_const + i], 0))
        for k in range(qd):
            sources_z.append((qt[2 * k], qt[2 * k + 1]))

        ch_iter = iter(deep_pows)
        h_val = E_ZERO

        def quotening(sources, values, point):
            nonlocal h_val
            acc = E_ZERO
            for s, v in zip(sources, values):
                lam = next(ch_iter)
                diff = ext2.s2_sub(tuple(int(x) % P for x in s), tuple(v))
                acc = ext2.s2_add(acc, ext2.s2_mul(diff, lam))
            den = ext2.s2_sub((x_q, 0), tuple(point))
            h_val = ext2.s2_add(h_val, ext2.s2_mul(acc, ext2.s2_inv(den)))

        quotening(sources_z, vals, z_pt)
        zw = ext2.s2_mul(z_pt, (omega, 0))
        quotening([(s2_[0], s2_[1])], [v_z_omega], zw)
        if lp.lookup_is_allowed:
            srcs0 = []
            a_off = 2 * (1 + num_intermediates)
            for i in range(num_lookup_subargs):
                srcs0.append((s2_[a_off + 2 * i], s2_[a_off + 2 * i + 1]))
            b_off = a_off + 2 * num_lookup_subargs
            srcs0.append((s2_[b_off], s2_[b_off + 1]))
            quotening(srcs0, [tuple(v) for v in proof.values_at_0], (0, 0))
        for open_at, subset in pub_tuples.items():
            srcs = [(w[col], 0) for (col, _) in subset]
            vs = [(value, 0) for (_, value) in subset]
            quotening(srcs, vs, (open_at, 0))

        # FRI: base layer leaf must contain h(x_q); then fold down
        cur_domain = n
        cur_inner = inner_idx
        cur_coset_pow = 1  # exponent doubling of g per fold
        expected = h_val
        cur_full = full_size
        g_cur = g
        for layer_i, k in enumerate(schedule):
            fq = q.fri_queries[layer_i]
            elems_per_leaf = 1 << k
            if len(fq.leaf_elements) != 2 * elems_per_leaf:
                return _fail("fri leaf length mismatch")
            layer_depth = max((cur_full // elems_per_leaf).bit_length() - 1
                              - (cap_size.bit_length() - 1), 0)
            if len(fq.proof) != layer_depth:
                return _fail("fri merkle path depth mismatch")
            flat = coset_idx * cur_domain + cur_inner
            leaf_i = flat // elems_per_leaf
            cap = proof.fri_base_oracle_cap if layer_i == 0 \
                else proof.fri_intermediate_oracles_caps[layer_i - 1]
            lh = leaf_hash(fq.leaf_elements)
            kwargs = {"permutation": hasher} if hasher in ("poseidon", "poseidon2") \
                else {"algo": hasher}
            if not verify_path(fq.proof, cap, lh, leaf_i, **kwargs):
                return _fail("fri merkle path failed")
            # position inside leaf must equal the expected value
            pos = flat % elems_per_leaf
            c0s = [int(x) % P for x in fq.leaf_elements[:elems_per_leaf]]
            c1s = [int(x) % P for x in fq.leaf_elements[elems_per_leaf:]]
            if (c0s[pos], c1s[pos]) != expected:
                return _fail("fri leaf value != expected fold input")
            # fold the leaf down to one value with this stage's challenge
            ch = fri_challenges[layer_i]
            base_flat = leaf_i * elems_per_leaf
            log_cur_full = cur_full.bit_length() - 1
            rev_tab = ntt.bitreverse_indices(log_cur_full)
            xs = [(g_cur * pow(domain_generator(log_cur_full),
                               int(rev_tab[base_flat + t]), P)) % P
                  for t in range(elems_per_leaf)]
            vals_fold = list(zip(c0s, c1s))
            cur_ch = ch
            while len(vals_fold) > 1:
                nxt = []
                nxt_xs = []
                for t in range(0, len(vals_fold), 2):
                    fx, fmx = vals_fold[t], vals_fold[t + 1]
                    x_inv = pow(xs[t], P - 2, P)
                    diff = ext2.s2_mul(ext2.s2_sub(fx, fmx), (x_inv, 0))
                    folded = ext2.s2_add(ext2.s2_add(fx, fmx),
                                         ext2.s2_mul(cur_ch, diff))
                    nxt.append(folded)
                    nxt_xs.append((xs[t] * xs[t]) % P)
                vals_fold = nxt
                xs = nxt_xs
                cur_ch = ext2.s2_mul(cur_ch, cur_ch)
            expected = vals_fold[0]
            cur_inner >>= k
            cur_domain >>= k
            cur_full >>= k
            g_cur = pow(g_cur, 1 << k, P)

        # final: evaluate the final monomials at the final-layer point
        x_fin = (g_cur * pow(domain_generator(cur_full.bit_length() - 1),
                             int(ntt.bitreverse_indices(cur_full.bit_length() - 1)
                                 [coset_idx * cur_domain + cur_inner]), P)) % P
        acc = E_ZERO
        xp = E_ONE
        for c0v, c1v in zip(proof.final_fri_monomials[0],
                            proof.final_fri_monomials[1]):
            acc = ext2.s2_add(acc, ext2.s2_mul(xp, (int(c0v), int(c1v))))
            xp = ext2.s2_mul(xp, (x_fin, 0))
        if acc != expected:
            return _fail("final monomial evaluation mismatch")

    return True
