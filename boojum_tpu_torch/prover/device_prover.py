# Port of boojum_tpu/prover/device_prover.py (one single-device path).
"""The device prover on torch tensors: setup oracle, then one prove.

The stage sequence is the reference's host `prove`
(`boojum_tpu/prover/prover.py:184-780`, whose proofs are byte-equal to
the reference `DeviceProver`'s), with every column-sized array a tensor on
``device``: host witness columns and host transcript; stage 2 (copy
permutation grand product, lookup A/B polys); the quotient over the flat
(qd·n) domain; its coset iNTT; evaluations at z, z·ω and 0; DEEP; FRI; and
the query openings. NTTs run through the `ntt_stage` kernel and every Merkle
tree through the `poseidon2_permute` kernel on the GPU.

Not ported, and raising NotImplementedError: general-purpose lookup mode,
the device transcript, `pow_bits > 0`, and tree hashers other than
poseidon2. The device witness program is not ported either: the witness is
always materialized on the host.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..cs.gates.base import TorchOps, TraceView
from ..cs.setup import non_residues_for_copy_permutation
from ..field import extension as ext2
from ..field import goldilocks as gl
from ..ntt import ntt
from ..transcript import make_transcript
from ..utils import npgl
from . import device as dops
from .device_merkle import do_fri_device
from .fri import _inverse_roots_bitreversed, compute_fri_schedule
from .jit_ops import EV, affine
from .oracles import DeviceOracle, eval_monomial_sets_at
from .proof import Proof, ProofConfig, SingleRoundQueries
from .prover import (ProvingArtifacts, _BoolsBuffer, _s2, _u64_from_lsb,
                     make_vk, materialize_witness_columns)

P = npgl.ORDER


def resolve_device(device) -> torch.device:
    """The torch device to run on; asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %r was asked for but CUDA is not "
                           "available; pass device='cpu' to run on the CPU"
                           % (device,))
    return dev


def _check_supported(cs, proof_config: ProofConfig, hasher: str):
    if hasher != "poseidon2":
        raise NotImplementedError("tree hasher %r is not ported" % hasher)
    if proof_config.pow_bits > 0:
        raise NotImplementedError("proof of work (pow_bits > 0) is not ported")
    lp = cs.lookup_parameters
    if lp.lookup_is_allowed and not lp.is_specialized:
        raise NotImplementedError("general-purpose lookup mode is not ported")


def create_device_setup(cs, setup_base, proof_config: ProofConfig,
                        hasher: str = "poseidon2", device="cuda"):
    """Setup oracle (sigmas ++ constants ++ table columns) on ``device`` and
    the VK; the cap equals the reference's."""
    dev = resolve_device(device)
    _check_supported(cs, proof_config, hasher)
    cols = np.concatenate([setup_base.copy_permutation_polys,
                           setup_base.constant_columns,
                           setup_base.lookup_tables_columns], axis=0)
    lde = max(proof_config.fri_lde_factor, setup_base.quotient_degree)
    oracle = DeviceOracle(cols, lde, proof_config.merkle_tree_cap_size, hasher,
                          tree_lde=proof_config.fri_lde_factor, device=dev)
    vk = make_vk(cs, setup_base, proof_config, oracle.get_cap())
    return ProvingArtifacts(setup_base=setup_base, setup_oracle=oracle, vk=vk)


class DeviceProver:
    def __init__(self, cs, artifacts: ProvingArtifacts,
                 proof_config: ProofConfig, device="cuda"):
        self.device = resolve_device(device)
        sb = artifacts.setup_base
        self.cs = cs
        self.artifacts = artifacts
        self.cfg = proof_config
        self.n = sb.domain_size
        self.qd = sb.quotient_degree
        self.fri_lde = proof_config.fri_lde_factor
        self.last_stage_times = {}
        self._tables = None  # prove-invariant device tables, built once

    def _invariant_tables(self):
        """Device tables that depend only on the domain: X over the quotient
        and FRI domains, the unnormalized L1, 1/Z_H per quotient coset and
        the FRI inverse roots."""
        if self._tables is None:
            n, qd, fri_lde, dev = self.n, self.qd, self.fri_lde, self.device
            vi = dops.vanishing_inverse_per_coset(n, qd)
            self._tables = {
                "x_lde": gl.from_u64(dops.x_poly_lde_host(n, qd), dev).reshape(-1),
                "x_fri": gl.from_u64(dops.x_poly_lde_host(n, fri_lde), dev).reshape(-1),
                "l1": dops.unnormalized_l1_lde(n, qd, dev).reshape(-1),
                "vanish_inv": gl.from_u64(np.repeat(vi, n), dev),
                "roots": gl.from_u64(_inverse_roots_bitreversed(fri_lde * n), dev),
            }
        return self._tables

    def prove(self, transcript_kind: str = "poseidon",
              hasher: str = "poseidon2", verbose: bool = False,
              device_transcript: bool = None) -> Proof:
        if device_transcript:
            raise NotImplementedError("the device transcript is not ported")
        cs = self.cs
        cfg = self.cfg
        _check_supported(cs, cfg, hasher)
        dev = self.device
        ops = TorchOps(dev)
        sb = self.artifacts.setup_base
        setup_oracle = self.artifacts.setup_oracle
        vk = self.artifacts.vk
        n, qd, fri_lde = self.n, self.qd, self.fri_lde
        log_n = n.bit_length() - 1
        used_lde = max(fri_lde, qd)
        cap_size = cfg.merkle_tree_cap_size
        geometry = cs.geometry
        lp = cs.lookup_parameters
        omega = gl.domain_generator(log_n)
        tables = self._invariant_tables()

        self.last_stage_times = {}
        t_last = [time.time()]

        def stage(label):
            # stage split for verbose runs: syncs so each stage owns its time
            if verbose:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                now = time.time()
                self.last_stage_times[label] = now - t_last[0]
                print("[torch-prove] %-24s %.3fs" % (label, now - t_last[0]),
                      file=sys.stderr, flush=True)
                t_last[0] = now

        def oracle(cols, lde, tree_lde=None, monomials=None):
            return DeviceOracle(cols, lde, cap_size, hasher,
                                tree_lde=tree_lde, monomials=monomials,
                                device=dev)

        transcript = make_transcript(transcript_kind)

        # -- stage 0: bind VK cap and public inputs ---------------------------
        transcript.witness_merkle_tree_cap(vk.setup_merkle_tree_cap)
        variables_cols, witness_cols, mult_cols = \
            materialize_witness_columns(cs, n)
        public_inputs_with_values = [(col, row, int(variables_cols[col, row]))
                                     for (col, row) in cs.public_inputs]
        public_input_values = [v for (_, _, v) in public_inputs_with_values]
        transcript.witness_field_elements(public_input_values)
        stage("witness columns")

        # -- stage 1: witness oracle -----------------------------------------
        num_var_polys = variables_cols.shape[0]
        num_wit_polys = witness_cols.shape[0]
        num_mult_polys = mult_cols.shape[0]
        witness_oracle = oracle(
            np.concatenate([variables_cols, witness_cols, mult_cols], axis=0),
            used_lde, tree_lde=fri_lde)
        transcript.witness_merkle_tree_cap(witness_oracle.get_cap())
        num_sigma_polys = sb.copy_permutation_polys.shape[0]
        num_const_polys = sb.constant_columns.shape[0]
        num_table_polys = sb.lookup_tables_columns.shape[0]
        assert num_sigma_polys == num_var_polys
        # base-domain columns, sliced from the oracles' Lagrange tensors
        var_base = witness_oracle.lagrange.T  # (k, n) views
        mult_base = var_base[num_var_polys + num_wit_polys:]
        setup_base_cols = setup_oracle.lagrange.T
        sigma_base = setup_base_cols[:num_sigma_polys]
        const_base = setup_base_cols[num_sigma_polys:num_sigma_polys + num_const_polys]
        table_base = setup_base_cols[num_sigma_polys + num_const_polys:]
        stage("witness oracle")

        # -- stage 2: copy permutation z + partial products -------------------
        beta = _s2(tuple(transcript.get_multiple_challenges(2)))
        gamma = _s2(tuple(transcript.get_multiple_challenges(2)))
        x_vals = gl.from_u64(npgl.powers(omega, n), dev)
        non_res = non_residues_for_copy_permutation(n, num_var_polys)

        chunk_ratios = []
        for start in range(0, num_var_polys, qd):
            num = EV.const((1, 0), (n,), dev)
            den = EV.const((1, 0), (n,), dev)
            for j in range(start, min(start + qd, num_var_polys)):
                w = var_base[j]
                num = num * EV(*affine(w, gl.mul(x_vals, non_res[j]), beta, gamma))
                den = den * EV(*affine(w, sigma_base[j], beta, gamma))
            chunk_ratios.append(num * den.inv())
        ratio = chunk_ratios[0]
        for r in chunk_ratios[1:]:
            ratio = ratio * r
        z_vals = EV(*dops.grand_product_exclusive(ratio.a))
        intermediates = []
        prev = z_vals
        for r in chunk_ratios[:-1]:
            prev = prev * r
            intermediates.append(prev)
        stage("copy-permutation z")

        # -- stage 3: lookup A/B polys (specialized mode) ---------------------
        lookup_a_polys, lookup_b_polys = [], []
        num_lookup_subargs = lp.num_sublookup_arguments_for_geometry(geometry)
        if lp.lookup_is_allowed:
            lookup_beta = _s2(tuple(transcript.get_multiple_challenges(2)))
            lookup_gamma = _s2(tuple(transcript.get_multiple_challenges(2)))
            width = lp.lookup_width()
            gamma_pows = [(1, 0)]
            for _ in range(width):
                gamma_pows.append(ext2.s2_mul(gamma_pows[-1], lookup_gamma))
            pw = lp.specialized_columns_per_repetition()
            base_off = geometry.num_columns_under_copy_permutation
            tid_cols = sb.table_ids_column_idxes

            def aggregate(cols, tid_col, size):
                agg = EV.const(lookup_beta, (size,), dev)
                for i, col in enumerate(cols):
                    agg = agg + EV(*ext2.base_scale(col, gamma_pows[i]))
                if tid_col is not None:
                    agg = agg + EV(*ext2.base_scale(tid_col, gamma_pows[width]))
                return agg

            for rep in range(num_lookup_subargs):
                cols = [var_base[base_off + rep * pw + i] for i in range(pw)]
                tid = const_base[tid_cols[min(rep, len(tid_cols) - 1)]] \
                    if lp.id_in_constant else None
                lookup_a_polys.append(aggregate(cols, tid, n).inv())
            agg_t = aggregate(list(table_base), None, n)
            lookup_b_polys.append(agg_t.inv().mul_base(mult_base[0]))
        stage("lookup A/B")

        # -- stage 4: stage-2 oracle -------------------------------------------
        stage2_polys = [z_vals] + intermediates + lookup_a_polys + lookup_b_polys
        stage2_lagrange = torch.stack([c for p in stage2_polys for c in p.a], dim=1)
        del stage2_polys, chunk_ratios, ratio
        stage2_oracle = oracle(stage2_lagrange, used_lde, tree_lde=fri_lde)
        num_stage2 = stage2_lagrange.shape[1]
        del stage2_lagrange
        transcript.witness_merkle_tree_cap(stage2_oracle.get_cap())
        stage("stage-2 oracle")

        # -- stage 5: alpha powers ---------------------------------------------
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
        lookup_alphas = iter(alpha_pows[:total_lookup_terms])
        spec_alphas = iter(alpha_pows[total_lookup_terms:
                                      total_lookup_terms + total_specialized_terms])
        general_alphas = iter(alpha_pows[total_lookup_terms + total_specialized_terms:
                                         total_lookup_terms + total_specialized_terms
                                         + total_general_terms])
        rem_alphas = iter(alpha_pows[total_lookup_terms + total_specialized_terms
                                     + total_general_terms:])

        # -- stage 6: quotient accumulation over the flat (qd·n) domain -------
        size = qd * n
        acc = EV.const((0, 0), (size,), dev)
        x_lde = tables["x_lde"]
        var_flat = [witness_oracle.flat(i, qd) for i in range(num_var_polys)]
        wit_flat = [witness_oracle.flat(num_var_polys + i, qd)
                    for i in range(num_wit_polys)]
        mult_flat = [witness_oracle.flat(num_var_polys + num_wit_polys + i, qd)
                     for i in range(num_mult_polys)]
        sigma_flat = [setup_oracle.flat(i, qd) for i in range(num_sigma_polys)]
        const_flat = [setup_oracle.flat(num_sigma_polys + i, qd)
                      for i in range(num_const_polys)]
        table_flat = [setup_oracle.flat(num_sigma_polys + num_const_polys + i, qd)
                      for i in range(num_table_polys)]
        stage2_flat = [stage2_oracle.flat(i, qd) for i in range(num_stage2)]

        def ext_flat(i):
            return EV(stage2_flat[i], stage2_flat[i + 1])

        a_off = 2 * (1 + num_intermediates)
        # 6a. lookup terms: A·agg - 1 per subargument, B·agg_t - mult
        if lp.lookup_is_allowed:
            for rep in range(num_lookup_subargs):
                cols = [var_flat[base_off + rep * pw + i] for i in range(pw)]
                tid = const_flat[tid_cols[min(rep, len(tid_cols) - 1)]] \
                    if lp.id_in_constant else None
                term = ext_flat(a_off + 2 * rep) * aggregate(cols, tid, size)
                term = EV(gl.sub(term.c0, 1), term.c1)
                acc = acc + term.scale(next(lookup_alphas))
            b_off = a_off + 2 * num_lookup_subargs
            term = ext_flat(b_off) * aggregate(table_flat, None, size)
            term = EV(gl.sub(term.c0, mult_flat[0]), term.c1)
            acc = acc + term.scale(next(lookup_alphas))

        # 6b. specialized gates: active on every row, no selector
        lookup_spec_cols = cs.specialized_copy_data.shape[0] \
            if cs.specialized_copy_data is not None else 0
        for (sname, sstart, sreps) in cs.gate_spec_layout:
            sev = cs.evaluators_specialized[cs.specialized_idx_by_name[sname]]
            base = geometry.num_columns_under_copy_permutation + \
                lookup_spec_cols + sstart
            for rep in range(sreps):
                cols = [var_flat[base + rep * sev.num_variables + i]
                        for i in range(sev.num_variables)]
                for term in sev.evaluate(TraceView(cols, [], []), ops):
                    term = term.expand(size)
                    acc = acc + EV(*ext2.base_scale(term, next(spec_alphas)))

        # 6c. general-purpose gate terms under selector path products
        selector_cache = {}

        def selector_product(path):
            key = tuple(path)
            if key not in selector_cache:
                prod = gl.full((size,), 1, dev)
                for k, bit in enumerate(path):
                    col = const_flat[k]
                    prod = gl.mul(prod, col if bit else gl.sub(gl.full((), 1, dev), col))
                selector_cache[key] = prod
            return selector_cache[key]

        for ev_idx, ev in enumerate(cs.evaluators_general):
            if ev.num_quotient_terms == 0:
                continue
            path = sb.selector_paths[ev_idx]
            sel = selector_product(path)
            src = TraceView(var_flat, wit_flat, const_flat[len(path):])
            terms = ev.evaluate_repetitions(src, ops, geometry)
            assert len(terms) == ev.num_quotient_terms * ev.num_repetitions(geometry)
            for term in terms:
                contrib = gl.mul(term.expand(size), sel)
                acc = acc + EV(*ext2.base_scale(contrib, next(general_alphas)))
        del selector_cache

        # 6d. copy-permutation terms
        z_flat = ext_flat(0)
        zm1 = EV(gl.sub(z_flat.c0, 1), z_flat.c1)
        acc = acc + zm1.mul_base(tables["l1"]).scale(next(rem_alphas))

        # z(x·ω): monomials c_k·ω^k, then its qd-coset LDE
        scale_w = gl.from_u64(npgl.powers(omega, n), dev)
        z_shift_mono = gl.mul(stage2_oracle.monomials[:, 0:2], scale_w[:, None])
        zs = dops.monomials_to_lde(z_shift_mono, qd)  # (qd, n, 2)
        z_shifted = EV(zs[:, :, 0].reshape(-1), zs[:, :, 1].reshape(-1))
        del zs

        lhs_list = [ext_flat(2 + 2 * i) for i in range(num_intermediates)]
        lhs_list.append(z_shifted)
        rhs_list = [z_flat] + [ext_flat(2 + 2 * i) for i in range(num_intermediates)]
        for rel_idx, (lhs, rhs) in enumerate(zip(lhs_list, rhs_list)):
            a = next(rem_alphas)
            for j in range(rel_idx * qd, min(rel_idx * qd + qd, num_var_polys)):
                w = var_flat[j]
                lhs = lhs * EV(*affine(w, sigma_flat[j], beta, gamma))
                rhs = rhs * EV(*affine(w, gl.mul(x_lde, non_res[j]), beta, gamma))
            acc = acc + (lhs - rhs).scale(a)
        del lhs_list, rhs_list, z_shifted
        stage("quotient sweep")

        # -- stage 7: divide by the vanishing poly, coset iNTT, chunk ---------
        acc = acc.mul_base(tables["vanish_inv"])
        g = gl.MULTIPLICATIVE_GENERATOR
        q2 = torch.stack([acc.c0, acc.c1], dim=1)  # (qd·n, 2)
        del acc
        if (qd * n).bit_length() - 1 >= 14:
            q_mono = ntt.coset_intt_fourstep_cols(q2, g)
        else:
            q_mono = ntt.coset_intt_cols(q2, g, ntt.get_plan((qd * n).bit_length() - 1))
        if cs.config.runtime_asserts:
            last = gl.to_u64(q_mono[-1])
            if last[0] or last[1]:
                cs.check_if_satisfied(verbose=True)
                raise AssertionError("unsatisfied circuit (see row report above)")
        # chunk k of component c -> monomial column 2k + c, (n, 2·qd)
        quotient_monomials = q_mono.reshape(qd, n, 2).permute(1, 0, 2) \
            .reshape(n, 2 * qd).contiguous()
        del q_mono, q2
        quotient_oracle = oracle(None, fri_lde, monomials=quotient_monomials)
        transcript.witness_merkle_tree_cap(quotient_oracle.get_cap())
        stage("quotient oracle")

        # -- stage 8: evaluations at z, z·ω, 0 ---------------------------------
        z_pt = _s2(tuple(transcript.get_multiple_challenges(2)))
        zw = ext2.s2_mul(z_pt, (omega, 0))
        w_mono = witness_oracle.monomials
        s_mono = setup_oracle.monomials
        st2_mono = stage2_oracle.monomials
        q_mono_t = quotient_oracle.monomials
        (w_z, s_z, st2_z, q_z, st2_zw) = eval_monomial_sets_at([
            (w_mono, z_pt), (s_mono, z_pt), (st2_mono, z_pt), (q_mono_t, z_pt),
            (st2_mono[:, 0:2], zw)])

        def ext_vals(base_vals, pairs):
            out = []
            for (i0, i1) in pairs:
                f0, f1 = base_vals[i0], base_vals[i1]
                # f0(z) + u·f1(z): u·(a + b·u) = 7b + a·u
                out.append(((f0[0] + 7 * f1[1]) % P, (f0[1] + f1[0]) % P))
            return out

        values_at_z = []
        values_at_z.extend(w_z[:num_var_polys + num_wit_polys])
        values_at_z.extend(s_z[num_sigma_polys:num_sigma_polys + num_const_polys])
        values_at_z.extend(s_z[:num_sigma_polys])
        values_at_z.extend(ext_vals(st2_z, [(0, 1)] + [(2 + 2 * i, 3 + 2 * i)
                                                       for i in range(num_intermediates)]))
        if lp.lookup_is_allowed:
            values_at_z.extend(w_z[num_var_polys + num_wit_polys:
                                   num_var_polys + num_wit_polys + num_mult_polys])
            values_at_z.extend(ext_vals(st2_z, [(a_off + 2 * i, a_off + 2 * i + 1)
                                                for i in range(num_lookup_subargs)]))
            b_off = a_off + 2 * num_lookup_subargs
            values_at_z.extend(ext_vals(st2_z, [(b_off, b_off + 1)]))
            values_at_z.extend(s_z[num_sigma_polys + num_const_polys:
                                   num_sigma_polys + num_const_polys + num_table_polys])
        values_at_z.extend(ext_vals(q_z, [(2 * k, 2 * k + 1) for k in range(qd)]))
        for v in values_at_z:
            transcript.witness_field_elements([v[0], v[1]])

        values_at_z_omega = ext_vals(st2_zw, [(0, 1)])
        transcript.witness_field_elements([values_at_z_omega[0][0],
                                           values_at_z_omega[0][1]])

        # values at 0 of A_i and B: the constant coefficients
        values_at_0 = []
        if lp.lookup_is_allowed:
            row0 = gl.to_u64(st2_mono[0])
            for i in range(num_lookup_subargs):
                values_at_0.append((int(row0[a_off + 2 * i]),
                                    int(row0[a_off + 2 * i + 1])))
            values_at_0.append((int(row0[b_off]), int(row0[b_off + 1])))
            for v in values_at_0:
                transcript.witness_field_elements([v[0], v[1]])
        stage("evaluations")

        # -- stage 9: DEEP linear combination ----------------------------------
        deep = _s2(tuple(transcript.get_multiple_challenges(2)))
        pub_tuples = {}
        for (col, row, value) in public_inputs_with_values:
            pub_tuples.setdefault(pow(omega, row, P), []).append((col, value))
        total_ch = len(values_at_z) + 1 + len(values_at_0) + \
            sum(len(s) for s in pub_tuples.values())
        deep_pows = [(1, 0)]
        for _ in range(total_ch - 1):
            deep_pows.append(ext2.s2_mul(deep_pows[-1], deep))
        ch_iter = iter(deep_pows)

        fsize = fri_lde * n
        x_fri = tables["x_fri"]
        h = EV.const((0, 0), (fsize,), dev)

        def add_quotening(sources, values, point):
            nonlocal h
            acc_l = EV.const((0, 0), (fsize,), dev)
            for (s, v) in zip(sources, values):
                lam = next(ch_iter)
                c1 = s[1] if s[1] is not None else gl.full((), 0, dev)
                diff = EV(gl.sub(s[0], v[0]), gl.sub(c1, v[1]).expand(fsize))
                acc_l = acc_l + diff.scale(lam)
            den = EV(gl.sub(x_fri, point[0]),
                     gl.neg(gl.full((fsize,), point[1], dev)))
            h = h + acc_l * den.inv()

        def base_src(orc, idx):
            return (orc.flat(idx, fri_lde), None)

        def ext_src(orc, i0, i1):
            return (orc.flat(i0, fri_lde), orc.flat(i1, fri_lde))

        sources_z = [base_src(witness_oracle, i)
                     for i in range(num_var_polys + num_wit_polys)]
        sources_z += [base_src(setup_oracle, num_sigma_polys + i)
                      for i in range(num_const_polys)]
        sources_z += [base_src(setup_oracle, i) for i in range(num_sigma_polys)]
        sources_z.append(ext_src(stage2_oracle, 0, 1))
        sources_z += [ext_src(stage2_oracle, 2 + 2 * i, 3 + 2 * i)
                      for i in range(num_intermediates)]
        if lp.lookup_is_allowed:
            sources_z += [base_src(witness_oracle, num_var_polys + num_wit_polys + i)
                          for i in range(num_mult_polys)]
            sources_z += [ext_src(stage2_oracle, a_off + 2 * i, a_off + 2 * i + 1)
                          for i in range(num_lookup_subargs)]
            sources_z.append(ext_src(stage2_oracle, b_off, b_off + 1))
            sources_z += [base_src(setup_oracle, num_sigma_polys + num_const_polys + i)
                          for i in range(num_table_polys)]
        sources_z += [ext_src(quotient_oracle, 2 * k, 2 * k + 1) for k in range(qd)]
        assert len(sources_z) == len(values_at_z)
        add_quotening(sources_z, values_at_z, z_pt)
        add_quotening([ext_src(stage2_oracle, 0, 1)], values_at_z_omega, zw)
        if lp.lookup_is_allowed:
            sources_0 = [ext_src(stage2_oracle, a_off + 2 * i, a_off + 2 * i + 1)
                         for i in range(num_lookup_subargs)]
            sources_0.append(ext_src(stage2_oracle, b_off, b_off + 1))
            add_quotening(sources_0, values_at_0, (0, 0))
        for open_at, subset in pub_tuples.items():
            srcs = [base_src(witness_oracle, col) for (col, _) in subset]
            add_quotening(srcs, [(value, 0) for (_, value) in subset], (open_at, 0))
        stage("DEEP")

        # -- stage 10: FRI ------------------------------------------------------
        new_pow_bits, num_queries, schedule, _ = compute_fri_schedule(
            cfg.security_level, cap_size, cfg.pow_bits,
            fri_lde.bit_length() - 1, log_n)
        assert new_pow_bits == 0
        fri_result = do_fri_device(h.a, transcript, schedule, fri_lde,
                                   cap_size, tables["roots"])
        del h
        stage("FRI")

        # -- stage 12: queries (no PoW: pow_bits == 0) -------------------------
        max_needed_bits = (n * fri_lde).bit_length() - 1
        num_inner_bits = max_needed_bits - (fri_lde.bit_length() - 1)
        bools = _BoolsBuffer(max_needed_bits)
        picks = []
        for _ in range(num_queries):
            bits = bools.get_bits(transcript, max_needed_bits)
            picks.append((_u64_from_lsb(bits[num_inner_bits:]),
                          _u64_from_lsb(bits[:num_inner_bits])))
        flat_idx = [c * n + i for (c, i) in picks]
        main = [witness_oracle, stage2_oracle, quotient_oracle, setup_oracle]
        rows = [o.query_many(flat_idx) for o in main]
        for o in main:
            o.tree.prefetch_proofs(flat_idx)
        fri_oracles = [fri_result.base_oracle] + fri_result.intermediate_oracles
        fri_idx = [[] for _ in schedule]
        for (coset_idx, inner_idx) in picks:
            cur_domain, cur_inner = n, inner_idx
            for s, k in enumerate(schedule):
                fri_idx[s].append(coset_idx * cur_domain + cur_inner)
                cur_inner >>= k
                cur_domain >>= k
        for o, idx in zip(fri_oracles, fri_idx):
            o.prefetch(idx)

        rounds = []
        for q, (coset_idx, inner_idx) in enumerate(picks):
            w_q, s2_q, q_q, su_q = (o.query(coset_idx, inner_idx, r, q)
                                    for o, r in zip(main, rows))
            fri_queries = [o.query(idx[q]) for o, idx in zip(fri_oracles, fri_idx)]
            rounds.append(SingleRoundQueries(w_q, s2_q, q_q, su_q, fri_queries))
        stage("queries")

        return Proof(
            proof_config=cfg,
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
            pow_challenge=0,
        )
