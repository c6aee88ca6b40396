# Copied from boojum_tpu/prover/prover.py (the host prove, its device parts on torch).
"""The proving pipeline: the host `prove`, and the host parts that
`device_prover.DeviceProver` shares.

Reference behavior: prove_cpu_basic (src/cs/implementations/prover.rs:153) —
the stage order, transcript absorption order, oracle leaf layouts, challenge
derivations and DEEP/FRI structure reproduced stage by stage (SURVEY §3.2).

The host `prove` keeps the reference's host numpy arithmetic (gates under
`NpOps`, `utils/npgl.py`); its device parts — the oracles' LDEs and trees
(`oracles.CommittedOracle`, `oracles.FlatOracle`), the shifted z LDE and the
quotient's iNTT — run on a torch device, the kernels on a GPU.
`DeviceProver` is the port's fast prover; both give the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..cs.cs import ConstraintSystem
from ..cs.gates.base import NpOps, TraceView
from ..cs.setup import SetupBase, non_residues_for_copy_permutation
from ..field import extension as ext2
from ..field import goldilocks as gl
from ..ntt import ntt
from ..transcript import make_transcript
from ..utils import npgl
from . import device as dops
from . import pow as pow_mod
from .fri import compute_fri_schedule, do_fri
from .oracles import CommittedOracle
from .proof import (Proof, ProofConfig, SingleRoundQueries, VerificationKey,
                    VerificationKeyCircuitGeometry)

P = npgl.ORDER


# ---------------------------------------------------------------------------
# Witness materialization (reference take_witness_using_hints, witness.rs)
# ---------------------------------------------------------------------------


def materialize_witness_columns(cs: ConstraintSystem, n: int):
    """Gather resolved values into (num_var_polys, n), (num_wit_polys, n),
    (num_mult_polys, n) host u64; placeholder cells are zero."""
    copy_cols, wit_cols, spec_cols = cs.materialize_value_columns(n)
    variables = np.concatenate([copy_cols, spec_cols], axis=0)
    mults = _multiplicity_columns(cs, n)
    return variables, wit_cols, mults


def _multiplicity_columns(cs: ConstraintSystem, n: int) -> np.ndarray:
    if not cs.lookup_parameters.lookup_is_allowed:
        return np.zeros((0, n), np.uint64)
    col = np.zeros(n, np.uint64)
    idx = 0
    for mults in cs.lookup_multiplicities:
        m = mults.shape[0]
        col[idx:idx + m] = mults.astype(np.uint64)
        idx += m
    return col[None, :]


# ---------------------------------------------------------------------------
# Helpers on flat LDE arrays
# ---------------------------------------------------------------------------


def _flat(oracle: CommittedOracle, qd: int, poly: int) -> np.ndarray:
    """First qd cosets of a committed poly's LDE, flattened (qd*n,) u64."""
    return oracle.lde_host[:qd, :, poly].reshape(-1)


def _ext_flat(oracle: CommittedOracle, qd: int, pair: tuple[int, int]):
    return (_flat(oracle, qd, pair[0]), _flat(oracle, qd, pair[1]))


def _np_ext_mul(a, b):
    v0 = npgl.mul(a[0], b[0])
    v1 = npgl.mul(a[1], b[1])
    c0 = npgl.add(v0, npgl.mul(v1, np.uint64(7)))
    t = npgl.mul(npgl.add(a[0], a[1]), npgl.add(b[0], b[1]))
    return (c0, npgl.sub(npgl.sub(t, v0), v1))


def _np_ext_add(a, b):
    return (npgl.add(a[0], b[0]), npgl.add(a[1], b[1]))


def _np_ext_sub(a, b):
    return (npgl.sub(a[0], b[0]), npgl.sub(a[1], b[1]))


def _np_ext_scale(a, c):  # ext array * ext scalar
    return _np_ext_mul(a, (np.uint64(c[0]), np.uint64(c[1])))


def _np_ext_mul_base(a, b):  # ext array * base array
    return (npgl.mul(a[0], b), npgl.mul(a[1], b))


def _np_ext_inv(a):
    norm = npgl.sub(npgl.mul(a[0], a[0]),
                    npgl.mul(npgl.mul(a[1], a[1]), np.uint64(7)))
    ninv = npgl.batch_inv(norm)  # native Montgomery chain when available
    return (npgl.mul(a[0], ninv), npgl.neg(npgl.mul(a[1], ninv)))


def _s2(c):  # host scalar ext tuple
    return (int(c[0]) % P, int(c[1]) % P)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


@dataclass
class ProvingArtifacts:
    """Everything reusable across proofs of the same circuit."""
    setup_base: SetupBase
    setup_oracle: "DeviceOracle"  # or a CommittedOracle (host prove)
    vk: VerificationKey


def make_vk(cs: ConstraintSystem, setup_base: SetupBase,
            proof_config: ProofConfig, setup_cap) -> VerificationKey:
    """VK from an already-committed setup cap (shared by the host and
    device setup paths; reference materialize_setup_storage_and_vk)."""
    evaluator_specs = [(ev.name, ev.spec_params())
                       for ev in cs.evaluators_general]
    specialized_specs = [(ev.name, ev.spec_params())
                         for ev in cs.evaluators_specialized]
    fixed = VerificationKeyCircuitGeometry(
        geometry=cs.geometry,
        lookup_parameters=cs.lookup_parameters,
        domain_size=setup_base.domain_size,
        total_tables_len=cs.lookups_tables_total_len(),
        public_inputs_locations=list(cs.public_inputs),
        extra_constant_polys_for_selectors=(
            setup_base.num_general_constant_columns
            - cs.geometry.num_constant_columns),
        table_ids_column_idxes=list(setup_base.table_ids_column_idxes),
        quotient_degree=setup_base.quotient_degree,
        selector_paths=[list(p) for p in setup_base.selector_paths],
        evaluator_specs=evaluator_specs,
        fri_lde_factor=proof_config.fri_lde_factor,
        cap_size=proof_config.merkle_tree_cap_size,
        num_variable_polys=(cs.geometry.num_columns_under_copy_permutation
                            + (cs.specialized_copy_data.shape[0]
                               if cs.specialized_copy_data is not None else 0)
                            + (cs.gate_spec_data.shape[0]
                               if cs.gate_spec_data is not None else 0)),
        specialized_evaluator_specs=specialized_specs,
        gate_spec_layout=[list(t) for t in cs.gate_spec_layout],
        num_witness_polys=cs.geometry.num_witness_columns,
        num_constant_polys=setup_base.constant_columns.shape[0],
        num_multiplicity_polys=(1 if cs.lookup_parameters.lookup_is_allowed else 0),
        security_level=proof_config.security_level,
        pow_bits=proof_config.pow_bits,
    )
    return VerificationKey(fixed_parameters=fixed,
                           setup_merkle_tree_cap=setup_cap)


def create_setup_and_vk(cs: ConstraintSystem, setup_base: SetupBase,
                        proof_config: ProofConfig, hasher: str,
                        device="cuda") -> ProvingArtifacts:
    """Commit the setup (sigmas ++ constants ++ table columns) and build the
    VK (reference materialize_setup_storage_and_vk, setup.rs:1179); the
    LDE and the tree are computed on ``device``."""
    from .device_prover import resolve_device
    device = resolve_device(device)
    cols = np.concatenate([setup_base.copy_permutation_polys,
                           setup_base.constant_columns,
                           setup_base.lookup_tables_columns], axis=0)
    lde = max(proof_config.fri_lde_factor, setup_base.quotient_degree)
    oracle = CommittedOracle(cols, lde, proof_config.merkle_tree_cap_size, hasher,
                             tree_lde=proof_config.fri_lde_factor,
                             device=device)
    vk = make_vk(cs, setup_base, proof_config, oracle.get_cap())
    return ProvingArtifacts(setup_base=setup_base, setup_oracle=oracle, vk=vk)


@torch.inference_mode()
def prove(cs: ConstraintSystem, artifacts: ProvingArtifacts,
          proof_config: ProofConfig, transcript_kind: str = "poseidon2",
          hasher: str = "poseidon2", verbose: bool = False,
          device="cuda") -> Proof:
    """The host prove: every stage's arithmetic in host numpy (gates under
    `NpOps`), the LDEs, NTTs and Merkle trees on ``device`` (the kernels on
    a GPU). Its artifacts come from `create_setup_and_vk`. Byte-identical
    to `DeviceProver.prove` and to the reference's host prove."""
    import sys as _sys
    import time as _time
    from .device_prover import resolve_device

    device = resolve_device(device)
    _t = [_time.time()]

    def _stage(label):
        if verbose:
            now = _time.time()
            print("[prove] %-28s %.2fs" % (label, now - _t[0]),
                  file=_sys.stderr, flush=True)
            _t[0] = now

    setup_base = artifacts.setup_base
    setup_oracle = artifacts.setup_oracle
    vk = artifacts.vk
    n = setup_base.domain_size
    log_n = n.bit_length() - 1
    qd = setup_base.quotient_degree
    fri_lde = proof_config.fri_lde_factor
    used_lde = max(fri_lde, qd)
    cap_size = proof_config.merkle_tree_cap_size
    geometry = cs.geometry
    lp = cs.lookup_parameters
    omega = gl.domain_generator(log_n)

    transcript = make_transcript(transcript_kind)

    # -- stage 0: bind VK cap and public inputs ----------------------------
    transcript.witness_merkle_tree_cap(vk.setup_merkle_tree_cap)
    variables_cols, witness_cols, mult_cols = materialize_witness_columns(cs, n)
    public_inputs_with_values = []
    for (col, row) in cs.public_inputs:
        public_inputs_with_values.append((col, row, int(variables_cols[col, row])))
    public_input_values = [v for (_, _, v) in public_inputs_with_values]
    transcript.witness_field_elements(public_input_values)

    _stage("stage0: publics+witness cols")
    # -- stage 1: witness oracle ------------------------------------------
    witness_src = np.concatenate([variables_cols, witness_cols, mult_cols], axis=0)
    witness_oracle = CommittedOracle(witness_src, used_lde, cap_size, hasher,
                                     tree_lde=fri_lde, device=device)
    transcript.witness_merkle_tree_cap(witness_oracle.get_cap())

    num_var_polys = variables_cols.shape[0]
    num_wit_polys = witness_cols.shape[0]
    num_mult_polys = mult_cols.shape[0]
    num_sigma_polys = setup_base.copy_permutation_polys.shape[0]
    num_const_polys = setup_base.constant_columns.shape[0]
    num_table_polys = setup_base.lookup_tables_columns.shape[0]
    assert num_sigma_polys == num_var_polys

    _stage("stage1: witness oracle")
    # -- stage 2: copy permutation z + partial products --------------------
    beta = _s2(tuple(transcript.get_multiple_challenges(2)))
    gamma = _s2(tuple(transcript.get_multiple_challenges(2)))

    x_vals = npgl.powers(omega, n)  # identity poly on base domain
    non_res = non_residues_for_copy_permutation(n, num_var_polys)
    sigmas = setup_base.copy_permutation_polys

    # per-chunk elementwise rational products (host ext, vectorized)
    chunk_ratios = []  # per chunk of qd columns: (c0, c1) arrays (n,)
    for start in range(0, num_var_polys, qd):
        num = (np.ones(n, np.uint64), np.zeros(n, np.uint64))
        den = (np.ones(n, np.uint64), np.zeros(n, np.uint64))
        for j in range(start, min(start + qd, num_var_polys)):
            w = variables_cols[j]
            bx = npgl.mul_scalar(x_vals, non_res[j])
            num_j = (npgl.add(npgl.add(w, npgl.mul_scalar(bx, beta[0])), np.uint64(gamma[0])),
                     npgl.add(npgl.mul_scalar(bx, beta[1]), np.uint64(gamma[1])))
            den_j = (npgl.add(npgl.add(w, npgl.mul_scalar(sigmas[j], beta[0])), np.uint64(gamma[0])),
                     npgl.add(npgl.mul_scalar(sigmas[j], beta[1]), np.uint64(gamma[1])))
            num = _np_ext_mul(num, num_j)
            den = _np_ext_mul(den, den_j)
        chunk_ratios.append(_np_ext_mul(num, _np_ext_inv(den)))

    # z poly: exclusive grand product of the product of all chunk ratios
    ratio = chunk_ratios[0]
    for r in chunk_ratios[1:]:
        ratio = _np_ext_mul(ratio, r)
    z_vals = npgl.ext_exclusive_prefix_mul(ratio)

    # intermediate partials: partial_i = z * chunk_0 * ... * chunk_i
    intermediates = []
    prev = z_vals
    for r in chunk_ratios[:-1]:
        prev = _np_ext_mul(prev, r)
        intermediates.append(prev)

    _stage("stage2: copy-perm products")
    # -- stage 3: lookup A/B polys ----------------------------------------
    lookup_a_polys = []  # per subargument: (c0, c1) arrays
    lookup_b_polys = []
    lookup_beta = (0, 0)
    lookup_gamma = (0, 0)
    num_lookup_subargs = lp.num_sublookup_arguments_for_geometry(geometry)
    if lp.lookup_is_allowed:
        lookup_beta = _s2(tuple(transcript.get_multiple_challenges(2)))
        lookup_gamma = _s2(tuple(transcript.get_multiple_challenges(2)))
        width = lp.lookup_width()
        gamma_pows = [(1, 0)]
        for _ in range(width):
            gamma_pows.append(ext2.s2_mul(gamma_pows[-1], lookup_gamma))
        if lp.is_specialized:
            pw = lp.specialized_columns_per_repetition()
            base_off = geometry.num_columns_under_copy_permutation
            sel_base = None  # specialized lookups run on every row: A = 1/agg
        else:
            # general-purpose: A_i = sel(x)/agg_i(x), sel = marker's selector
            # path product over the base-domain constant columns
            pw = lp.columns_per_subargument()
            base_off = 0
            marker_path = setup_base.selector_paths[0]
            sel_base = np.ones(n, np.uint64)
            for k_, bit in enumerate(marker_path):
                col = setup_base.constant_columns[k_]
                sel_base = npgl.mul(sel_base,
                                    col if bit else npgl.sub(np.uint64(1), col))
        for rep in range(num_lookup_subargs):
            agg = (np.full(n, lookup_beta[0], np.uint64),
                   np.full(n, lookup_beta[1], np.uint64))
            for i in range(pw):
                col = variables_cols[base_off + rep * pw + i]
                agg = _np_ext_add(agg, (npgl.mul_scalar(col, gamma_pows[i][0]),
                                        npgl.mul_scalar(col, gamma_pows[i][1])))
            if lp.id_in_constant:
                tid_cols = setup_base.table_ids_column_idxes
                table_id_col = setup_base.constant_columns[
                    tid_cols[min(rep, len(tid_cols) - 1)]]
                agg = _np_ext_add(
                    agg, (npgl.mul_scalar(table_id_col, gamma_pows[width][0]),
                          npgl.mul_scalar(table_id_col, gamma_pows[width][1])))
            a_poly = _np_ext_inv(agg)
            if sel_base is not None:
                a_poly = _np_ext_mul_base(a_poly, sel_base)
            lookup_a_polys.append(a_poly)
        # B: multiplicities over aggregated table columns
        agg_t = (np.full(n, lookup_beta[0], np.uint64),
                 np.full(n, lookup_beta[1], np.uint64))
        for i in range(num_table_polys):
            col = setup_base.lookup_tables_columns[i]
            agg_t = _np_ext_add(agg_t, (npgl.mul_scalar(col, gamma_pows[i][0]),
                                        npgl.mul_scalar(col, gamma_pows[i][1])))
        b = _np_ext_mul_base(_np_ext_inv(agg_t), mult_cols[0])
        lookup_b_polys.append(b)

    _stage("stage3: lookup A/B")
    # -- stage 4: stage-2 oracle ------------------------------------------
    stage2_cols = [z_vals[0], z_vals[1]]
    for p in intermediates:
        stage2_cols.extend([p[0], p[1]])
    for p in lookup_a_polys:
        stage2_cols.extend([p[0], p[1]])
    for p in lookup_b_polys:
        stage2_cols.extend([p[0], p[1]])
    stage2_oracle = CommittedOracle(np.stack(stage2_cols), used_lde, cap_size,
                                    hasher, tree_lde=fri_lde, device=device)
    transcript.witness_merkle_tree_cap(stage2_oracle.get_cap())

    _stage("stage4: stage2 oracle")
    # -- stage 5: alpha powers --------------------------------------------
    alpha = _s2(tuple(transcript.get_multiple_challenges(2)))
    num_intermediates = len(intermediates)
    total_lookup_terms = num_lookup_subargs + num_mult_polys
    total_specialized_terms = sum(
        cs.evaluators_specialized[cs.specialized_idx_by_name[name]]
        .num_quotient_terms * reps
        for (name, _, reps) in cs.gate_spec_layout)
    total_general_terms = sum(
        ev.num_quotient_terms * ev.num_repetitions(geometry)
        for ev in cs.evaluators_general)
    total_terms = (total_lookup_terms + total_specialized_terms
                   + total_general_terms + 1 + 1 + num_intermediates)
    alpha_pows = [(1, 0)]
    for _ in range(total_terms - 1):
        alpha_pows.append(ext2.s2_mul(alpha_pows[-1], alpha))
    lookup_alphas = alpha_pows[:total_lookup_terms]
    specialized_alphas = alpha_pows[total_lookup_terms:
                                    total_lookup_terms + total_specialized_terms]
    general_alphas = alpha_pows[total_lookup_terms + total_specialized_terms:
                                total_lookup_terms + total_specialized_terms
                                + total_general_terms]
    remaining_alphas = alpha_pows[total_lookup_terms + total_specialized_terms
                                  + total_general_terms:]

    _stage("stage5: alphas")
    # -- stage 6: quotient accumulation over (qd, n) LDE -------------------
    size = qd * n
    acc = (np.zeros(size, np.uint64), np.zeros(size, np.uint64))
    x_lde = dops.x_poly_lde_host(n, qd).reshape(-1)

    var_flat = [_flat(witness_oracle, qd, i) for i in range(num_var_polys)]
    wit_flat = [_flat(witness_oracle, qd, num_var_polys + i)
                for i in range(num_wit_polys)]
    mult_flat = [_flat(witness_oracle, qd, num_var_polys + num_wit_polys + i)
                 for i in range(num_mult_polys)]
    sigma_flat = [_flat(setup_oracle, qd, i) for i in range(num_sigma_polys)]
    const_flat = [_flat(setup_oracle, qd, num_sigma_polys + i)
                  for i in range(num_const_polys)]
    table_flat = [_flat(setup_oracle, qd, num_sigma_polys + num_const_polys + i)
                  for i in range(num_table_polys)]
    stage2_flat = [_flat(stage2_oracle, qd, i)
                   for i in range(len(stage2_cols))]

    # 6a. lookup terms
    if lp.lookup_is_allowed:
        width = lp.lookup_width()
        if lp.is_specialized:
            pw = lp.specialized_columns_per_repetition()
            base_off = geometry.num_columns_under_copy_permutation
            sel_lde = None  # A·agg − 1 (active on every row)
        else:
            pw = lp.columns_per_subargument()
            base_off = 0
            marker_path = setup_base.selector_paths[0]
            sel_lde = np.ones(size, np.uint64)
            for k_, bit in enumerate(marker_path):
                col = const_flat[k_]
                sel_lde = npgl.mul(sel_lde,
                                   col if bit else npgl.sub(np.uint64(1), col))
        a_off = 2 * (1 + num_intermediates)
        it = iter(lookup_alphas)
        for rep in range(num_lookup_subargs):
            agg = (np.full(size, lookup_beta[0], np.uint64),
                   np.full(size, lookup_beta[1], np.uint64))
            for i in range(pw):
                col = var_flat[base_off + rep * pw + i]
                agg = _np_ext_add(agg, (npgl.mul_scalar(col, gamma_pows[i][0]),
                                        npgl.mul_scalar(col, gamma_pows[i][1])))
            if lp.id_in_constant:
                tid_cols = setup_base.table_ids_column_idxes
                tid_flat = const_flat[tid_cols[min(rep, len(tid_cols) - 1)]]
                agg = _np_ext_add(
                    agg, (npgl.mul_scalar(tid_flat, gamma_pows[width][0]),
                          npgl.mul_scalar(tid_flat, gamma_pows[width][1])))
            a_poly = (stage2_flat[a_off + 2 * rep], stage2_flat[a_off + 2 * rep + 1])
            term = _np_ext_mul(a_poly, agg)
            if sel_lde is None:
                term = (npgl.sub(term[0], np.uint64(1)), term[1])
            else:
                term = (npgl.sub(term[0], sel_lde), term[1])
            acc = _np_ext_add(acc, _np_ext_scale(term, next(it)))
        # B term
        agg_t = (np.full(size, lookup_beta[0], np.uint64),
                 np.full(size, lookup_beta[1], np.uint64))
        for i in range(num_table_polys):
            agg_t = _np_ext_add(agg_t, (npgl.mul_scalar(table_flat[i], gamma_pows[i][0]),
                                        npgl.mul_scalar(table_flat[i], gamma_pows[i][1])))
        b_off = a_off + 2 * num_lookup_subargs
        b_poly = (stage2_flat[b_off], stage2_flat[b_off + 1])
        term = _np_ext_mul(b_poly, agg_t)
        term = _np_ext_sub(term, (mult_flat[0], np.zeros(size, np.uint64)))
        acc = _np_ext_add(acc, _np_ext_scale(term, next(it)))

    # 6c. general-purpose gate terms under selector path products
    selector_cache: dict[tuple, np.ndarray] = {}

    def selector_product(path):
        key = tuple(path)
        if key in selector_cache:
            return selector_cache[key]
        prod = np.ones(size, np.uint64)
        for k, bit in enumerate(path):
            col = const_flat[k]
            prod = npgl.mul(prod, col if bit else npgl.sub(np.uint64(1), col))
        selector_cache[key] = prod
        return prod

    # specialized gates: active on every row, no selector
    spec_alpha_it = iter(specialized_alphas)
    lookup_spec_cols = cs.specialized_copy_data.shape[0] \
        if cs.specialized_copy_data is not None else 0
    for (sname, sstart, sreps) in cs.gate_spec_layout:
        sev = cs.evaluators_specialized[cs.specialized_idx_by_name[sname]]
        base = geometry.num_columns_under_copy_permutation + lookup_spec_cols \
            + sstart
        for rep in range(sreps):
            cols = [var_flat[base + rep * sev.num_variables + i]
                    for i in range(sev.num_variables)]
            for term in sev.evaluate(TraceView(cols, [], []), NpOps):
                a = next(spec_alpha_it)
                term = np.broadcast_to(term, (size,))
                acc = _np_ext_add(acc, (npgl.mul_scalar(term, a[0]),
                                        npgl.mul_scalar(term, a[1])))

    gen_alpha_it = iter(general_alphas)
    for ev_idx, ev in enumerate(cs.evaluators_general):
        num_terms = ev.num_quotient_terms * ev.num_repetitions(geometry)
        if ev.num_quotient_terms == 0:
            continue
        path = setup_base.selector_paths[ev_idx]
        sel = selector_product(path)
        gate_consts = const_flat[len(path):]
        src = TraceView(var_flat, wit_flat, gate_consts)
        terms = _evaluate_gate_np(ev, src, geometry)
        assert len(terms) == num_terms
        for term in terms:
            a = next(gen_alpha_it)
            contrib = npgl.mul(term, sel)
            acc = _np_ext_add(acc, (npgl.mul_scalar(contrib, a[0]),
                                    npgl.mul_scalar(contrib, a[1])))

    # 6d. copy permutation terms
    rem_it = iter(remaining_alphas)
    l1_unnorm = dops.unnormalized_l1_lde_host(n, qd).reshape(-1)
    z_flat = (stage2_flat[0], stage2_flat[1])
    a0 = next(rem_it)
    zm1 = (npgl.sub(z_flat[0], np.uint64(1)), z_flat[1])
    boundary = _np_ext_mul_base(zm1, l1_unnorm)
    acc = _np_ext_add(acc, _np_ext_scale(boundary, a0))

    # z shifted: z(xω) has monomials c_k·ω^k
    scale = gl.from_u64(npgl.powers(omega, n), device)
    z_shift_mono = gl.mul(stage2_oracle.monomials[:, 0:2], scale[:, None])
    zs = dops.from_device(dops.monomials_to_lde(z_shift_mono, qd))
    z_shifted_flat = (np.ascontiguousarray(zs[:, :, 0]).reshape(-1),
                      np.ascontiguousarray(zs[:, :, 1]).reshape(-1))

    lhs_list = []
    rhs_list = []
    for i in range(num_intermediates):
        lhs_list.append((stage2_flat[2 + 2 * i], stage2_flat[3 + 2 * i]))
    lhs_list.append(z_shifted_flat)
    rhs_list.append(z_flat)
    for i in range(num_intermediates):
        rhs_list.append((stage2_flat[2 + 2 * i], stage2_flat[3 + 2 * i]))

    for rel_idx, (lhs, rhs) in enumerate(zip(lhs_list, rhs_list)):
        a = next(rem_it)
        start = rel_idx * qd
        cols = range(start, min(start + qd, num_var_polys))
        lhs_acc = lhs
        rhs_acc = rhs
        for j in cols:
            w = var_flat[j]
            den = (npgl.add(npgl.add(w, npgl.mul_scalar(sigma_flat[j], beta[0])),
                            np.uint64(gamma[0])),
                   npgl.add(npgl.mul_scalar(sigma_flat[j], beta[1]),
                            np.uint64(gamma[1])))
            bx = npgl.mul_scalar(x_lde, non_res[j])
            num_ = (npgl.add(npgl.add(w, npgl.mul_scalar(bx, beta[0])),
                             np.uint64(gamma[0])),
                    npgl.add(npgl.mul_scalar(bx, beta[1]), np.uint64(gamma[1])))
            lhs_acc = _np_ext_mul(lhs_acc, den)
            rhs_acc = _np_ext_mul(rhs_acc, num_)
        term = _np_ext_sub(lhs_acc, rhs_acc)
        acc = _np_ext_add(acc, _np_ext_scale(term, a))

    _stage("stage6: quotient accumulation")
    # -- stage 7: divide by vanishing, iNTT, chunk -------------------------
    vanish_inv = dops.vanishing_inverse_per_coset(n, qd)
    vi = np.repeat(vanish_inv, n)
    acc = _np_ext_mul_base(acc, vi)

    # full-domain iNTT on the device: flat layout is bitreversed over
    # g·<ω_{qd·n}>; both components in one batch
    g = gl.MULTIPLICATIVE_GENERATOR
    log_full = (qd * n).bit_length() - 1
    q2 = gl.from_u64(np.stack(acc, axis=1), device)  # (qd·n, 2)
    if log_full >= 14:
        q_mono = ntt.coset_intt_fourstep_cols(q2, g)
    else:
        q_mono = ntt.coset_intt_cols(q2, g, ntt.get_plan(log_full))
    q_mono_c0, q_mono_c1 = gl.to_u64(q_mono.T.contiguous())
    if cs.config.runtime_asserts:
        if q_mono_c0[-1] or q_mono_c1[-1]:
            # DEBUG_SATISFIABLE analogue (reference src/config.rs:7,
            # prover.rs:1386): pinpoint offending rows via the row oracle
            # instead of dividing by the vanishing poly.
            if cs.config.runtime_asserts:
                cs.check_if_satisfied(verbose=True)
            raise AssertionError("unsatisfied circuit (see row report above)")

    quotient_chunk_cols = []
    for k in range(qd):
        quotient_chunk_cols.append(q_mono_c0[k * n:(k + 1) * n])
        quotient_chunk_cols.append(q_mono_c1[k * n:(k + 1) * n])
    quotient_monomials = dops.to_device_cols(np.stack(quotient_chunk_cols),
                                             device)
    quotient_oracle = CommittedOracle.from_monomials(
        quotient_monomials, fri_lde, cap_size, hasher)
    transcript.witness_merkle_tree_cap(quotient_oracle.get_cap())

    _stage("stage7: quotient oracle")
    # -- stage 8: evaluations at z, z·ω, 0 ---------------------------------
    z_pt = _s2(tuple(transcript.get_multiple_challenges(2)))
    z_pows = npgl.ext_powers(z_pt, n)

    values_at_z = []
    values_at_z.extend(_eval_base_polys(witness_oracle, z_pows,
                                        range(num_var_polys + num_wit_polys)))
    values_at_z.extend(_eval_base_polys(setup_oracle, z_pows,
                                        range(num_sigma_polys,
                                              num_sigma_polys + num_const_polys)))
    values_at_z.extend(_eval_base_polys(setup_oracle, z_pows, range(num_sigma_polys)))
    values_at_z.extend(_eval_ext_polys(stage2_oracle, z_pows,
                                       [(0, 1)] + [(2 + 2 * i, 3 + 2 * i)
                                                   for i in range(num_intermediates)]))
    if lp.lookup_is_allowed:
        values_at_z.extend(_eval_base_polys(
            witness_oracle, z_pows,
            range(num_var_polys + num_wit_polys,
                  num_var_polys + num_wit_polys + num_mult_polys)))
        a_off = 2 * (1 + num_intermediates)
        values_at_z.extend(_eval_ext_polys(
            stage2_oracle, z_pows,
            [(a_off + 2 * i, a_off + 2 * i + 1) for i in range(num_lookup_subargs)]))
        b_off = a_off + 2 * num_lookup_subargs
        values_at_z.extend(_eval_ext_polys(stage2_oracle, z_pows, [(b_off, b_off + 1)]))
        values_at_z.extend(_eval_base_polys(
            setup_oracle, z_pows,
            range(num_sigma_polys + num_const_polys,
                  num_sigma_polys + num_const_polys + num_table_polys)))
    values_at_z.extend(_eval_ext_polys(
        quotient_oracle, z_pows, [(2 * k, 2 * k + 1) for k in range(qd)]))

    for v in values_at_z:
        transcript.witness_field_elements([v[0], v[1]])

    # z(z·ω)
    zw = ext2.s2_mul(z_pt, (omega, 0))
    zw_pows = npgl.ext_powers(zw, n)
    values_at_z_omega = _eval_ext_polys(stage2_oracle, zw_pows, [(0, 1)])
    transcript.witness_field_elements([values_at_z_omega[0][0],
                                       values_at_z_omega[0][1]])

    # values at 0 for A_i and B: constant coefficient of the monomials
    values_at_0 = []
    if lp.lookup_is_allowed:
        mono_host = stage2_oracle.monomials_host[0]  # row 0 = c_0
        a_off = 2 * (1 + num_intermediates)
        for i in range(num_lookup_subargs):
            values_at_0.append((int(mono_host[a_off + 2 * i]),
                                int(mono_host[a_off + 2 * i + 1])))
        b_off = a_off + 2 * num_lookup_subargs
        values_at_0.append((int(mono_host[b_off]), int(mono_host[b_off + 1])))
        for v in values_at_0:
            transcript.witness_field_elements([v[0], v[1]])

    _stage("stage8: evals at z")
    # -- stage 9: DEEP linear combination ----------------------------------
    deep = _s2(tuple(transcript.get_multiple_challenges(2)))
    # count challenges: per value at z, 1 for z_omega, per value at 0, publics
    pub_tuples = {}
    for (col, row, value) in public_inputs_with_values:
        open_at = pow(omega, row, P)
        pub_tuples.setdefault(open_at, []).append((col, value))
    total_ch = len(values_at_z) + 1 + len(values_at_0) + \
        sum(len(s) for s in pub_tuples.values())
    deep_pows = [(1, 0)]
    for _ in range(total_ch - 1):
        deep_pows.append(ext2.s2_mul(deep_pows[-1], deep))
    ch_iter = iter(deep_pows)

    fsize = fri_lde * n
    x_fri = dops.x_poly_lde_host(n, fri_lde).reshape(-1)
    h = (np.zeros(fsize, np.uint64), np.zeros(fsize, np.uint64))

    def add_quotening(sources, values, point):
        """sources: list of (c0_flat, c1_flat or None); values list of ext."""
        nonlocal h
        acc_l = (np.zeros(fsize, np.uint64), np.zeros(fsize, np.uint64))
        for (s, v) in zip(sources, values):
            lam = next(ch_iter)
            diff = (npgl.sub(s[0], np.uint64(v[0])),
                    npgl.sub(s[1] if s[1] is not None else np.zeros(fsize, np.uint64),
                             np.uint64(v[1])))
            acc_l = _np_ext_add(acc_l, _np_ext_scale(diff, lam))
        den = (npgl.sub(x_fri, np.uint64(point[0])),
               npgl.neg(np.full(fsize, point[1], np.uint64)))
        acc_l = _np_ext_mul(acc_l, _np_ext_inv(den))
        h = _np_ext_add(h, acc_l)

    def base_src(oracle, idx):
        return (_flat(oracle, fri_lde, idx), None)

    def ext_src(oracle, i0, i1):
        return (_flat(oracle, fri_lde, i0), _flat(oracle, fri_lde, i1))

    sources_z = []
    for i in range(num_var_polys + num_wit_polys):
        sources_z.append(base_src(witness_oracle, i))
    for i in range(num_const_polys):
        sources_z.append(base_src(setup_oracle, num_sigma_polys + i))
    for i in range(num_sigma_polys):
        sources_z.append(base_src(setup_oracle, i))
    sources_z.append(ext_src(stage2_oracle, 0, 1))
    for i in range(num_intermediates):
        sources_z.append(ext_src(stage2_oracle, 2 + 2 * i, 3 + 2 * i))
    if lp.lookup_is_allowed:
        for i in range(num_mult_polys):
            sources_z.append(base_src(witness_oracle,
                                      num_var_polys + num_wit_polys + i))
        a_off = 2 * (1 + num_intermediates)
        for i in range(num_lookup_subargs):
            sources_z.append(ext_src(stage2_oracle, a_off + 2 * i, a_off + 2 * i + 1))
        b_off = a_off + 2 * num_lookup_subargs
        sources_z.append(ext_src(stage2_oracle, b_off, b_off + 1))
        for i in range(num_table_polys):
            sources_z.append(base_src(setup_oracle,
                                      num_sigma_polys + num_const_polys + i))
    for k in range(qd):
        sources_z.append(ext_src(quotient_oracle, 2 * k, 2 * k + 1))
    assert len(sources_z) == len(values_at_z)
    add_quotening(sources_z, values_at_z, z_pt)
    add_quotening([ext_src(stage2_oracle, 0, 1)], values_at_z_omega, zw)
    if lp.lookup_is_allowed:
        sources_0 = []
        a_off = 2 * (1 + num_intermediates)
        for i in range(num_lookup_subargs):
            sources_0.append(ext_src(stage2_oracle, a_off + 2 * i, a_off + 2 * i + 1))
        b_off = a_off + 2 * num_lookup_subargs
        sources_0.append(ext_src(stage2_oracle, b_off, b_off + 1))
        add_quotening(sources_0, values_at_0, (0, 0))
    for open_at, subset in pub_tuples.items():
        srcs = [base_src(witness_oracle, col) for (col, _) in subset]
        vals = [(value, 0) for (_, value) in subset]
        add_quotening(srcs, vals, (open_at, 0))

    _stage("stage9: DEEP")
    # -- stage 10: FRI ------------------------------------------------------
    basic_pow_bits = proof_config.pow_bits
    new_pow_bits, num_queries, schedule, final_degree = compute_fri_schedule(
        proof_config.security_level, cap_size, basic_pow_bits,
        fri_lde.bit_length() - 1, log_n)
    fri_result = do_fri(h[0], h[1], transcript, schedule, fri_lde,
                        cap_size, hasher, device)

    _stage("stage10: FRI")
    # -- stage 11: PoW ------------------------------------------------------
    pow_challenge = 0
    if new_pow_bits > 0:
        challenges = transcript.get_multiple_challenges(4)
        grind = {"keccak256": pow_mod.keccak256_pow,
                 "poseidon2": pow_mod.poseidon2_pow,
                 }.get(proof_config.pow_hash, pow_mod.blake2s_pow)
        pow_challenge = grind(challenges, new_pow_bits)
        low = pow_challenge & 0xFFFFFFFF
        high = pow_challenge >> 32
        transcript.witness_field_elements([low, high])

    _stage("stage11: PoW")
    # -- stage 12: queries --------------------------------------------------
    max_needed_bits = (n * fri_lde).bit_length() - 1
    num_coset_bits = fri_lde.bit_length() - 1
    num_inner_bits = max_needed_bits - num_coset_bits
    bools = _BoolsBuffer(max_needed_bits)

    rounds = []
    for _ in range(num_queries):
        bits = bools.get_bits(transcript, max_needed_bits)
        inner_idx = _u64_from_lsb(bits[:num_inner_bits])
        coset_idx = _u64_from_lsb(bits[num_inner_bits:])
        witness_q = witness_oracle.query(coset_idx, inner_idx)
        stage2_q = stage2_oracle.query(coset_idx, inner_idx)
        quotient_q = quotient_oracle.query(coset_idx, inner_idx)
        setup_q = setup_oracle.query(coset_idx, inner_idx)
        fri_queries = []
        cur_domain = n
        cur_inner = inner_idx
        for idx, k in enumerate(schedule):
            flat_idx = coset_idx * cur_domain + cur_inner
            if idx == 0:
                fri_queries.append(fri_result.base_oracle.query(flat_idx))
            else:
                fri_queries.append(
                    fri_result.intermediate_oracles[idx - 1].query(flat_idx))
            cur_inner >>= k
            cur_domain >>= k
        rounds.append(SingleRoundQueries(witness_q, stage2_q, quotient_q,
                                         setup_q, fri_queries))

    _stage("stage12: queries")
    return Proof(
        proof_config=proof_config,
        public_inputs=public_input_values,
        witness_oracle_cap=witness_oracle.get_cap(),
        stage_2_oracle_cap=stage2_oracle.get_cap(),
        quotient_oracle_cap=quotient_oracle.get_cap(),
        final_fri_monomials=fri_result.monomial_forms,
        values_at_z=values_at_z,
        values_at_z_omega=values_at_z_omega,
        values_at_0=values_at_0,
        fri_base_oracle_cap=fri_result.base_oracle.get_cap(),
        fri_intermediate_oracles_caps=[o.get_cap()
                                       for o in fri_result.intermediate_oracles],
        queries_per_fri_repetition=rounds,
        pow_challenge=pow_challenge,
    )


# ---------------------------------------------------------------------------
# gate evaluation over numpy flat LDE arrays
# ---------------------------------------------------------------------------


def _evaluate_gate_np(ev, src: TraceView, geometry) -> list[np.ndarray]:
    return ev.evaluate_repetitions(src, NpOps, geometry)


def _eval_base_polys(oracle: CommittedOracle, z_pows, indices) -> list:
    """Host evaluation: Σ c_i·z^i per poly, vectorized over coefficients."""
    indices = list(indices)
    if not indices:
        return []
    mono = oracle.monomials_host[:, indices]  # (n, k)
    out = []
    for j in range(mono.shape[1]):
        col = mono[:, j]
        c0 = int(_mod_sum(npgl.mul(z_pows[0], col)))
        c1 = int(_mod_sum(npgl.mul(z_pows[1], col)))
        out.append((c0, c1))
    return out


def _mod_sum(a):
    """Modular sum of a u64 array: log n vectorized pairwise npgl.adds."""
    a = np.asarray(a, np.uint64)
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        s = npgl.add(a[:half], a[half:2 * half])
        if a.shape[0] % 2:
            s = np.concatenate([s, a[-1:]])
        a = s
    return a[0]


def _eval_ext_polys(oracle: CommittedOracle, z_pows, pairs) -> list:
    """Each pair (i0, i1) = (c0 poly, c1 poly); f = f0 + f1·u evaluated at z:
    f(z) = f0(z) + u·f1(z) with f0(z), f1(z) ext values."""
    out = []
    for (i0, i1) in pairs:
        vals = _eval_base_polys(oracle, z_pows, [i0, i1])
        f0, f1 = vals
        # f0(z) + u·f1(z): u·(a + b·u) = 7b + a·u
        c0 = (f0[0] + 7 * f1[1]) % P
        c1 = (f0[1] + f1[0]) % P
        out.append((c0, c1))
    return out


def _u64_from_lsb(bits) -> int:
    v = 0
    for i, b in enumerate(bits):
        if b:
            v |= 1 << i
    return v


class _BoolsBuffer:
    """Reference BoolsBuffer (transcript.rs:369)."""

    def __init__(self, max_needed: int):
        self.available: list[bool] = []
        self.max_needed = max_needed

    def get_bits(self, transcript, num_bits: int):
        while len(self.available) < num_bits:
            if transcript.IS_ALGEBRAIC:
                bits_available = 64 - self.max_needed
                el = transcript.get_challenge()
                for i in range(bits_available):
                    self.available.append(bool((el >> i) & 1))
            else:
                chunk = transcript.get_challenge_bytes(8)
                v = int.from_bytes(chunk, "little")
                for i in range(64):
                    self.available.append(bool((v >> i) & 1))
        out = self.available[:num_bits]
        del self.available[:num_bits]
        return out
