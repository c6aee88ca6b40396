# Port of boojum_tpu/prover/device_prover.py (one single-device path).
"""The device prover on torch tensors: setup oracle, then one prove.

The stage sequence is the reference's host `prove`
(`boojum_tpu/prover/prover.py:184-780`, whose proofs are byte-equal to
the reference `DeviceProver`'s), with every column-sized array a tensor on
``device``: host witness columns and host transcript; stage 2 (copy
permutation grand product, lookup A/B polys); the quotient over the flat
(qd·n) domain; its coset iNTT; evaluations at z, z·ω and 0; DEEP; FRI; and
the query openings. NTTs run through the `ntt_stage` kernel and every Merkle
tree through the leaf and node entries of the tree hasher's kernel on the
GPU: `poseidon2` (K2), `poseidon` (`poseidon_leaf_hashes` /
`poseidon_node_layer`), `blake2s` (K8) or `keccak256` (K9). With
``pow_bits > 0`` the host grinds the proof of work after FRI
(`prover/pow.py`), as the reference does.

As in the reference `DeviceProver`, the witness oracle comes from the device
witness program (`device_witness.DeviceWitnessProgram`, its SHA-256
compression chain on kernel K5) whenever the circuit supports it, and the
challenges from the device transcript (`device_transcript.DeviceTranscript`,
its sponge on kernel K6) by default on a CUDA device, under the reference's
condition (an algebraic transcript and an algebraic tree hasher: the
reference's poseidon2, and poseidon, whose trees the port also builds on
the device): every challenge stays on the device until one handoff to the
host transcript before the queries. The Blake2s and Keccak-256 transcripts
run on the host.

Every lookup mode of the reference runs: the specialized modes (A_i =
1/agg_i on every row) and the general-purpose ones, whose lookups sit on the
rows of the marker gate (A_i = sel/agg_i, sel the marker's selector-path
product over the constant columns; the reference's
`device_prover.py:776-800` and host `prover.py:294-321`). Every tree
hasher of the reference is ported.

Setup and prove run under `torch.inference_mode()`: nothing is
differentiated, and each of a prove's hundreds of thousands of ops skips
autograd's bookkeeping, a host cost per op. The tensors they make may be
read anywhere but changed in place only inside that mode.
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
from . import pow as pow_mod
from .device_merkle import (TREE_HASHERS, FetchCollector, do_fri_device,
                            finish_fri)
from .device_transcript import (DeviceTranscript, ext_pow_table_dev,
                                prepare_ext)
from .device_witness import DeviceWitnessProgram
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


def _check_supported(hasher: str):
    if hasher not in TREE_HASHERS:
        raise ValueError("unknown tree hasher %r" % (hasher,))


def _selector_product(path, const_cols, size, dev):
    """The selector of a gate at ``path`` in the selector tree: the product
    over its constant columns of c (bit 1) or 1 - c (bit 0)."""
    prod = gl.full((size,), 1, dev)
    for k, bit in enumerate(path):
        col = const_cols[k]
        prod = gl.mul(prod, col if bit else gl.sub(gl.full((), 1, dev), col))
    return prod


@torch.inference_mode()
def create_device_setup(cs, setup_base, proof_config: ProofConfig,
                        hasher: str = "poseidon2", device="cuda"):
    """Setup oracle (sigmas ++ constants ++ table columns) on ``device`` and
    the VK; the cap equals the reference's."""
    dev = resolve_device(device)
    _check_supported(hasher)
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
        self._witness_program = False  # not built yet; then a program or None

    def _invariant_tables(self):
        """Device tables that stay the same from prove to prove: X over the
        quotient and FRI domains, the unnormalized L1, 1/Z_H per quotient
        coset and the FRI inverse roots (the domain's), and in the
        general-purpose lookup modes the marker's selector over the base and
        the flat quotient domain (the setup's)."""
        if self._tables is None:
            n, qd, fri_lde, dev = self.n, self.qd, self.fri_lde, self.device
            vi = dops.vanishing_inverse_per_coset(n, qd)
            self._tables = {
                "x_lde": gl.from_u64(dops.x_poly_lde_host(n, qd), dev).reshape(-1),
                "x_fri": gl.from_u64(dops.x_poly_lde_host(n, fri_lde), dev).reshape(-1),
                "l1": dops.unnormalized_l1_lde(n, qd, dev).reshape(-1),
                "vanish_inv": gl.from_u64(np.repeat(vi, n), dev),
                "roots": gl.from_u64(_inverse_roots_bitreversed(fri_lde * n), dev),
                # ω^i on the base domain
                "x_vals": gl.from_u64(npgl.powers(gl.domain_generator(
                    n.bit_length() - 1), n), dev),
            }
            lp = self.cs.lookup_parameters
            if lp.lookup_is_allowed and not lp.is_specialized:
                sb = self.artifacts.setup_base
                orc = self.artifacts.setup_oracle
                first = sb.copy_permutation_polys.shape[0]
                path = sb.selector_paths[0]  # the marker is evaluator 0
                self._tables["sel_base"] = _selector_product(
                    path, orc.lagrange.T[first:], n, dev)
                self._tables["sel_flat"] = _selector_product(
                    path, [orc.flat(first + k, qd) for k in range(len(path))],
                    qd * n, dev)
        return self._tables

    def witness_program(self):
        """The circuit's DeviceWitnessProgram, built at the first prove, or
        None when the circuit does not support one."""
        if self._witness_program is False:
            self._witness_program = (
                DeviceWitnessProgram(self.cs, self.n, self.device)
                if DeviceWitnessProgram.supported(self.cs) else None)
        return self._witness_program

    @torch.inference_mode()
    def prove(self, transcript_kind: str = "poseidon",
              hasher: str = "poseidon2", verbose: bool = False,
              device_transcript: bool = None, on_stage=None) -> Proof:
        """``device_transcript``: None takes the device transcript on a CUDA
        device and the host one on the CPU (the reference's rule, fuse =
        off the CPU); True takes it anywhere (on the CPU through its plain
        versions); False keeps the host transcript. The device transcript
        needs an algebraic ``transcript_kind`` and an algebraic
        ``hasher`` (poseidon2 or poseidon); the byte transcripts and byte
        trees always run with the host transcript (True
        raises ValueError there). ``verbose`` prints the
        stage split (each stage ends in a device sync); ``on_stage(label)``,
        if given, is called at the end of each stage of that split, after
        the sync and outside the stages' times (`chip_smoke.py` profiles
        each stage through it)."""
        cs = self.cs
        cfg = self.cfg
        _check_supported(hasher)
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
            if verbose or on_stage is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                now = time.time()
                self.last_stage_times[label] = now - t_last[0]
                if verbose:
                    print("[torch-prove] %-24s %.3fs" % (label,
                                                         now - t_last[0]),
                          file=sys.stderr, flush=True)
                if on_stage is not None:
                    on_stage(label)
                t_last[0] = time.time()

        def oracle(cols, lde, tree_lde=None, monomials=None):
            return DeviceOracle(cols, lde, cap_size, hasher,
                                tree_lde=tree_lde, monomials=monomials,
                                device=dev)

        eligible = (transcript_kind in ("poseidon", "poseidon2")
                    and hasher in ("poseidon2", "poseidon"))
        if device_transcript and not eligible:
            raise ValueError("the device transcript needs the poseidon or "
                             "poseidon2 transcript and the poseidon2 or "
                             "poseidon tree hasher, not %r and %r"
                             % (transcript_kind, hasher))
        use_dev_ts = eligible and (dev.type == "cuda"
                                   if device_transcript is None
                                   else bool(device_transcript))
        transcript = (DeviceTranscript(transcript_kind, dev) if use_dev_ts
                      else make_transcript(transcript_kind))

        def absorb_cap(orc):
            if use_dev_ts:  # the device cap layer, no sync
                transcript.witness_merkle_tree_cap_dev(orc.tree.layers[-1])
            else:
                transcript.witness_merkle_tree_cap(orc.get_cap())

        def ext_challenge():
            if use_dev_ts:  # on the device, split once for the multiplies
                return prepare_ext(transcript.get_ext_challenge())
            return _s2(tuple(transcript.get_multiple_challenges(2)))

        def pow_table(c, count):
            """[1, c, .., c^(count-1)]: the prepared rows of a device table,
            or host pairs."""
            if use_dev_ts:
                return ext2.prepare(ext_pow_table_dev(c, count))
            pows = [(1, 0)]
            for _ in range(count - 1):
                pows.append(ext2.s2_mul(pows[-1], c))
            return pows

        # -- stage 0: bind VK cap and public inputs ---------------------------
        transcript.witness_merkle_tree_cap(vk.setup_merkle_tree_cap)
        num_var_polys = sb.copy_permutation_polys.shape[0]
        num_wit_polys = geometry.num_witness_columns
        num_mult_polys = 1 if lp.lookup_is_allowed else 0
        program = self.witness_program()
        if program is not None:
            # only the circuit inputs cross to the device
            public_inputs_with_values = []  # supported() excludes publics
            witness_src = program(getattr(cs, "witness_overrides", None))
            assert witness_src.shape == (
                n, num_var_polys + num_wit_polys + num_mult_polys)
            stage("witness materialize")
        else:
            variables_cols, witness_cols, mult_cols = \
                materialize_witness_columns(cs, n)
            public_inputs_with_values = [
                (col, row, int(variables_cols[col, row]))
                for (col, row) in cs.public_inputs]
            assert (variables_cols.shape[0], witness_cols.shape[0],
                    mult_cols.shape[0]) == (num_var_polys, num_wit_polys,
                                            num_mult_polys)
            witness_src = np.concatenate(
                [variables_cols, witness_cols, mult_cols], axis=0)
            stage("witness columns")
        public_input_values = [v for (_, _, v) in public_inputs_with_values]
        transcript.witness_field_elements(public_input_values)

        # -- stage 1: witness oracle -----------------------------------------
        witness_oracle = oracle(witness_src, used_lde, tree_lde=fri_lde)
        del witness_src
        absorb_cap(witness_oracle)
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
        beta = ext_challenge()
        gamma = ext_challenge()
        x_vals = tables["x_vals"]
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

        # -- stage 3: lookup A/B polys ------------------------------------------
        # Specialized modes: A_i = 1/agg_i on every row. General-purpose
        # modes: A_i = sel/agg_i, sel the marker gate's selector, so A_i is
        # 0 off the marker rows. A zero agg_i (inverted to 0, as the
        # reference's batch inverse does) on a row that looks up leaves
        # A·agg - sel = -1 there: the quotient is then not divisible, which
        # the top-coefficient check (runtime_asserts) reports.
        lookup_a_polys, lookup_b_polys = [], []
        num_lookup_subargs = lp.num_sublookup_arguments_for_geometry(geometry)
        if lp.lookup_is_allowed:
            lookup_beta = ext_challenge()
            lookup_gamma = ext_challenge()
            width = lp.lookup_width()
            gamma_pows = pow_table(lookup_gamma, width + 1)
            if lp.is_specialized:
                pw = lp.specialized_columns_per_repetition()
                base_off = geometry.num_columns_under_copy_permutation
            else:
                pw = lp.columns_per_subargument()  # the id column included
                base_off = 0
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
                a_poly = aggregate(cols, tid, n).inv()
                if not lp.is_specialized:
                    a_poly = a_poly.mul_base(tables["sel_base"])
                lookup_a_polys.append(a_poly)
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
        absorb_cap(stage2_oracle)
        stage("stage-2 oracle")

        # -- stage 5: alpha powers ---------------------------------------------
        alpha = ext_challenge()
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
        alpha_pows = pow_table(alpha, total_terms)
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
        # 6a. lookup terms: A·agg - 1 (specialized) or A·agg - sel (general)
        # per subargument, B·agg_t - mult
        if lp.lookup_is_allowed:
            one = 1 if lp.is_specialized else tables["sel_flat"]
            for rep in range(num_lookup_subargs):
                cols = [var_flat[base_off + rep * pw + i] for i in range(pw)]
                tid = const_flat[tid_cols[min(rep, len(tid_cols) - 1)]] \
                    if lp.id_in_constant else None
                term = ext_flat(a_off + 2 * rep) * aggregate(cols, tid, size)
                term = EV(gl.sub(term.c0, one), term.c1)
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
        for ev_idx, ev in enumerate(cs.evaluators_general):
            if ev.num_quotient_terms == 0:
                continue
            path = sb.selector_paths[ev_idx]
            sel = _selector_product(path, const_flat, size, dev)
            src = TraceView(var_flat, wit_flat, const_flat[len(path):])
            terms = ev.evaluate_repetitions(src, ops, geometry)
            assert len(terms) == ev.num_quotient_terms * ev.num_repetitions(geometry)
            for term in terms:
                contrib = gl.mul(term.expand(size), sel)
                acc = acc + EV(*ext2.base_scale(contrib, next(general_alphas)))

        # 6d. copy-permutation terms
        z_flat = ext_flat(0)
        zm1 = EV(gl.sub(z_flat.c0, 1), z_flat.c1)
        acc = acc + zm1.mul_base(tables["l1"]).scale(next(rem_alphas))

        # z(x·ω): monomials c_k·ω^k, then its qd-coset LDE
        z_shift_mono = gl.mul(stage2_oracle.monomials[:, 0:2], x_vals[:, None])
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
        # the quotient's top coefficient is zero for a satisfied circuit; it
        # is checked on the host at the next fetch (the evaluations', or the
        # device transcript's handoff), not with a wait of its own
        q_top = q_mono[-1:].clone() if cs.config.runtime_asserts else None

        def check_quotient_top(top):
            if top[0] or top[1]:
                cs.check_if_satisfied(verbose=True)
                raise AssertionError("unsatisfied circuit (see row report above)")
        # chunk k of component c -> monomial column 2k + c, (n, 2·qd)
        quotient_monomials = q_mono.reshape(qd, n, 2).permute(1, 0, 2) \
            .reshape(n, 2 * qd).contiguous()
        del q_mono, q2
        quotient_oracle = oracle(None, fri_lde, monomials=quotient_monomials)
        absorb_cap(quotient_oracle)
        stage("quotient oracle")

        # -- stage 8: evaluations at z, z·ω, 0 ---------------------------------
        # Every value is built on the device as a (k, 2) table. The device
        # transcript absorbs the tables interleaved; the host transcript
        # fetches them in one transfer and absorbs host pairs.
        z_pt = ext_challenge()
        if use_dev_ts:
            zw = prepare_ext(gl.mul(z_pt.pair(), omega))
        else:
            zw = ext2.s2_mul(z_pt, (omega, 0))
        w_mono = witness_oracle.monomials
        s_mono = setup_oracle.monomials
        st2_mono = stage2_oracle.monomials
        q_mono_t = quotient_oracle.monomials
        (w_z, s_z, st2_z, q_z, st2_zw) = eval_monomial_sets_at([
            (w_mono, z_pt), (s_mono, z_pt), (st2_mono, z_pt), (q_mono_t, z_pt),
            (st2_mono[:, 0:2], zw)])

        def base_range(vals, lo, hi):
            """Base polys lo..hi evaluated at an ext point."""
            return (vals[0][lo:hi], vals[1][lo:hi])

        def ext_range(vals, start, count):
            """The ext polys (start + 2i, start + 2i + 1), i < count, from
            their components' values f0, f1: f0(z) + u·f1(z), where
            u·(a + b·u) = 7b + a·u."""
            end = start + 2 * count
            f0 = (vals[0][start:end:2], vals[1][start:end:2])
            f1 = (vals[0][start + 1:end:2], vals[1][start + 1:end:2])
            return (gl.add(f0[0], gl.mul(f1[1], 7)), gl.add(f0[1], f1[0]))

        def table(parts):
            """Value groups -> one (k, 2) device table."""
            return torch.stack([torch.cat([p[0] for p in parts]),
                                torch.cat([p[1] for p in parts])], dim=1)

        parts = [base_range(w_z, 0, num_var_polys + num_wit_polys),
                 base_range(s_z, num_sigma_polys,
                            num_sigma_polys + num_const_polys),
                 base_range(s_z, 0, num_sigma_polys),
                 ext_range(st2_z, 0, 1 + num_intermediates)]
        b_off = a_off + 2 * num_lookup_subargs
        if lp.lookup_is_allowed:
            parts += [base_range(w_z, num_var_polys + num_wit_polys,
                                 num_var_polys + num_wit_polys + num_mult_polys),
                      ext_range(st2_z, a_off, num_lookup_subargs),
                      ext_range(st2_z, b_off, 1),
                      base_range(s_z, num_sigma_polys + num_const_polys,
                                 num_sigma_polys + num_const_polys
                                 + num_table_polys)]
        parts.append(ext_range(q_z, 0, qd))
        values = [table(parts), table([ext_range(st2_zw, 0, 1)])]
        if lp.lookup_is_allowed:
            # values at 0 of A_i and B: the constant coefficients
            row0 = st2_mono[0]
            values.append(torch.stack([row0[a_off:b_off + 2:2],
                                       row0[a_off + 1:b_off + 2:2]], dim=1))
        if use_dev_ts:
            for t in values:
                transcript.absorb_interleaved_dev(t[:, 0], t[:, 1])
            # DEEP's operands: each value as a pair of 0-dim tensors
            pairs = [list(zip(t[:, 0].unbind(0), t[:, 1].unbind(0)))
                     for t in values]
        else:
            tops = [] if q_top is None else [q_top]
            fetched = iter(gl.to_u64(torch.cat(values + tops)).tolist())
            values = pairs = [[tuple(next(fetched)) for _ in range(t.shape[0])]
                              for t in values]
            if q_top is not None:
                check_quotient_top(next(fetched))
            for t in values:
                transcript.witness_field_elements([x for r in t for x in r])
        values_at_z, values_at_z_omega = pairs[:2]
        values_at_0 = pairs[2] if lp.lookup_is_allowed else []
        stage("evaluations")

        # -- stage 9: DEEP linear combination ----------------------------------
        deep = ext_challenge()
        pub_tuples = {}
        for (col, row, value) in public_inputs_with_values:
            pub_tuples.setdefault(pow(omega, row, P), []).append((col, value))
        total_ch = len(values_at_z) + 1 + len(values_at_0) + \
            sum(len(s) for s in pub_tuples.values())
        ch_iter = iter(pow_table(deep, total_ch))

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
        fri_result = do_fri_device(h.a, transcript, schedule, fri_lde,
                                   cap_size, tables["roots"], hasher)
        del h
        fri_oracles = [fri_result.base_oracle] + fri_result.intermediate_oracles
        if use_dev_ts:
            # the one sync of the device transcript: its state and pending
            # pieces, the final FRI layer, the values at z, z·ω and 0 and
            # the oracle caps come to the host in one transfer; the host
            # transcript goes on from there
            capped = [witness_oracle, stage2_oracle, quotient_oracle] \
                + fri_oracles
            transcript, fetched = transcript.handoff_to_host(
                list(fri_result.final_layer[:2]) + values
                + [o.tree.layers[-1] for o in capped]
                + ([] if q_top is None else [q_top]))
            if q_top is not None:
                check_quotient_top(fetched.pop()[0])
            finish_fri(fri_result, fetched[0], fetched[1], transcript)
            pairs = [[(int(a), int(b)) for a, b in v]
                     for v in fetched[2:2 + len(values)]]
            values_at_z, values_at_z_omega = pairs[:2]
            values_at_0 = pairs[2] if lp.lookup_is_allowed else []
            for o, cap in zip(capped, fetched[2 + len(values):]):
                o.tree.set_cap_host(cap)
        stage("FRI")

        # -- stage 11: PoW, ground on the host (the reference's order) --------
        pow_challenge = 0
        if new_pow_bits > 0:
            challenges = transcript.get_multiple_challenges(4)
            grind = {"keccak256": pow_mod.keccak256_pow,
                     "poseidon2": pow_mod.poseidon2_pow,
                     }.get(cfg.pow_hash, pow_mod.blake2s_pow)
            pow_challenge = grind(challenges, new_pow_bits)
            transcript.witness_field_elements(
                [pow_challenge & 0xFFFFFFFF, pow_challenge >> 32])
            stage("PoW")

        # -- stage 12: queries ---------------------------------------------------
        max_needed_bits = (n * fri_lde).bit_length() - 1
        num_inner_bits = max_needed_bits - (fri_lde.bit_length() - 1)
        bools = _BoolsBuffer(max_needed_bits)
        picks = []
        for _ in range(num_queries):
            bits = bools.get_bits(transcript, max_needed_bits)
            picks.append((_u64_from_lsb(bits[num_inner_bits:]),
                          _u64_from_lsb(bits[:num_inner_bits])))
        flat_idx = [c * n + i for (c, i) in picks]
        # every gather of the query phase (leaf rows, Merkle paths, FRI
        # chunks) comes to the host in ONE transfer
        coll = FetchCollector()
        main = [witness_oracle, stage2_oracle, quotient_oracle, setup_oracle]
        rows = [o.query_many(flat_idx, collector=coll) for o in main]
        for o in main:
            o.tree.prefetch_proofs(flat_idx, collector=coll)
        fri_idx = [[] for _ in schedule]
        for (coset_idx, inner_idx) in picks:
            cur_domain, cur_inner = n, inner_idx
            for s, k in enumerate(schedule):
                fri_idx[s].append(coset_idx * cur_domain + cur_inner)
                cur_inner >>= k
                cur_domain >>= k
        for o, idx in zip(fri_oracles, fri_idx):
            o.prefetch(idx, collector=coll)
        coll.flush()
        rows = [r.value for r in rows]

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
            pow_challenge=pow_challenge,
        )
