# Port of boojum_tpu/prover/device_prover.py (one single-device path).
"""The device prover on torch tensors: setup oracle, then one prove.

The stage sequence is the reference's host `prove`
(`boojum_tpu/prover/prover.py:184-780`, whose proofs are byte-equal to
the reference `DeviceProver`'s), with every column-sized array a tensor on
``device``: host witness columns and host transcript; stages 2 and 3 (copy
permutation grand product, lookup A/B polys: `stage23.stage23`, on a GPU
two hand kernels in place of the reference's one program `_stage23_jit`,
its ops one by one on the sharded path, as the reference's mesh path runs
them); the quotient over the flat
(qd·n) domain (`quotient.quotient_sweep`: on a GPU one hand kernel that
runs every gate from the circuit's recorded tape, in place of the
reference's one program `_quotient_full_fn`, on the sharded path over
each rank's blocks); its coset iNTT; evaluations at z, z·ω and 0; DEEP; FRI; and
the query openings. NTTs run through the `ntt_stage` kernel and every Merkle
tree through the leaf and node entries of the tree hasher's kernel on the
GPU: `poseidon2` (K2), `poseidon` (`poseidon_leaf_hashes` /
`poseidon_node_layers`), `blake2s` (K8) or `keccak256` (K9). With
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

With a ``mesh`` (`parallel.sharding.make_mesh`), setup and prove run
sharded over its process group, one process a device: every rank runs the
whole prover on its rows (`parallel.sharding`'s layout), the oracles are
`parallel.sharded_oracle.ShardedOracle`, the copy-permutation grand product
is `distributed_grand_product`, the quotient's chunks come from one
distributed iNTT, the evaluations at z are summed across the ranks, the
FRI layers are sharded while each rank holds whole leaves, and the query
phase's one fetch is answered by the rows' owners. As in the reference's
mesh path (boojum_tpu/prover/device_prover.py:330, :667), the transcript
and the witness columns are the host's, replicated on every rank. Every
rank ends with the single-device proof's bytes.

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

from ..cs.setup import non_residues_for_copy_permutation
from ..field import extension as ext2
from ..field import goldilocks as gl
from ..ntt import ntt
from ..transcript import make_transcript
from ..utils import npgl
from . import device as dops
from . import pow as pow_mod
from . import quotient, stage23
from .device_merkle import (TREE_HASHERS, FetchCollector, do_fri_device,
                            finish_fri)
from .device_transcript import DeviceTranscript, ext_pow_list, prepare_ext
from .device_witness import DeviceWitnessProgram
from .fri import _inverse_roots_bitreversed, compute_fri_schedule
from .jit_ops import EV
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


def _check_supported(hasher: str, mesh=None):
    if hasher not in TREE_HASHERS:
        raise ValueError("unknown tree hasher %r" % (hasher,))
    if mesh is not None and hasher not in ("poseidon2", "poseidon"):
        raise ValueError("a sharded prove hashes its trees with poseidon2 or "
                         "poseidon, not %r" % (hasher,))


def _mesh_device(device, mesh) -> torch.device:
    """The device of a prover or a setup: the mesh's when there is one (and
    ``device`` must be of its type), else ``device``."""
    if mesh is None:
        return resolve_device(device)
    if torch.device(device).type != mesh.device.type:
        raise ValueError("device %r does not match the mesh's %s"
                         % (device, mesh.device))
    return mesh.device


@torch.inference_mode()
def create_device_setup(cs, setup_base, proof_config: ProofConfig,
                        hasher: str = "poseidon2", device="cuda", mesh=None):
    """Setup oracle (sigmas ++ constants ++ table columns) on ``device`` and
    the VK; the cap equals the reference's. With a ``mesh`` the oracle is
    sharded over it (the reference's device_prover.py:40-54)."""
    dev = _mesh_device(device, mesh)
    _check_supported(hasher, mesh)
    cols = np.concatenate([setup_base.copy_permutation_polys,
                           setup_base.constant_columns,
                           setup_base.lookup_tables_columns], axis=0)
    lde = max(proof_config.fri_lde_factor, setup_base.quotient_degree)
    if mesh is not None:
        from ..parallel.sharded_oracle import ShardedOracle
        oracle = ShardedOracle(mesh, cols, lde,
                               proof_config.merkle_tree_cap_size, hasher,
                               tree_lde=proof_config.fri_lde_factor)
    else:
        oracle = DeviceOracle(cols, lde, proof_config.merkle_tree_cap_size,
                              hasher, tree_lde=proof_config.fri_lde_factor,
                              device=dev)
    vk = make_vk(cs, setup_base, proof_config, oracle.get_cap())
    return ProvingArtifacts(setup_base=setup_base, setup_oracle=oracle, vk=vk)


class DeviceProver:
    def __init__(self, cs, artifacts: ProvingArtifacts,
                 proof_config: ProofConfig, device="cuda", mesh=None):
        """``mesh``: a `parallel.sharding.Mesh` to prove sharded over (its
        setup must come from `create_device_setup` on the same mesh), or
        None for one device."""
        self.device = _mesh_device(device, mesh)
        self.mesh = mesh
        if mesh is not None and \
                getattr(artifacts.setup_oracle, "mesh", None) is not mesh:
            raise ValueError("a sharded prover needs the setup of "
                             "create_device_setup(..., mesh=) on its mesh")
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
        coset and the FRI inverse roots (the domain's), the copy
        permutation's non-residues, the quotient's layout and its gate tape
        (`quotient.QuotientInputs`, recorded once, and the tape on the
        device), and in the general-purpose lookup modes the marker's
        selector over the base and the flat quotient domain (the
        setup's)."""
        if self._tables is None:
            n, qd, fri_lde, dev = self.n, self.qd, self.fri_lde, self.device
            # a sharded prover's rows of each coset (all of them on one
            # device); the FRI roots stay whole
            own = slice(None) if self.mesh is None else self.mesh.blocks(n)
            rows = n if self.mesh is None else n // self.mesh.size
            layout = quotient.QuotientInputs.of_circuit(
                self.cs, self.artifacts.setup_base)
            self._tables = {
                "x_lde": gl.from_u64(dops.x_poly_lde_host(n, qd)[:, own],
                                     dev).reshape(-1),
                "x_fri": gl.from_u64(dops.x_poly_lde_host(n, fri_lde)[:, own],
                                     dev).reshape(-1),
                "l1": dops.unnormalized_l1_lde(n, qd, dev, own).reshape(-1),
                "vanish_inv": gl.from_u64(
                    dops.vanishing_inverse_per_coset(n, qd), dev),
                "roots": gl.from_u64(_inverse_roots_bitreversed(fri_lde * n), dev),
                # ω^i on the base domain
                "x_vals": gl.from_u64(npgl.powers(gl.domain_generator(
                    n.bit_length() - 1), n)[own], dev),
                # the copy permutation's k_j (stages 2+3, the quotient)
                "non_res": stage23.NonResidues.make(
                    non_residues_for_copy_permutation(
                        n, self.artifacts.setup_base.copy_permutation_polys
                        .shape[0]), dev),
                "quotient": layout,
                "quotient_program": quotient.upload_tape(layout.tape, dev),
            }
            lp = self.cs.lookup_parameters
            if lp.lookup_is_allowed and not lp.is_specialized:
                sb = self.artifacts.setup_base
                orc = self.artifacts.setup_oracle
                first = sb.copy_permutation_polys.shape[0]
                path = sb.selector_paths[0]  # the marker is evaluator 0
                self._tables["sel_base"] = quotient.selector_product(
                    path, orc.lagrange.T[first:], rows, dev)
                self._tables["sel_flat"] = quotient.selector_product(
                    path, [orc.flat(first + k, qd) for k in range(len(path))],
                    qd * rows, dev)
        return self._tables

    def witness_program(self):
        """The circuit's DeviceWitnessProgram, built at the first prove, or
        None when the circuit does not support one or the prover is
        sharded (the reference's mesh path takes the host witness,
        boojum_tpu/prover/device_prover.py:667)."""
        if self._witness_program is False:
            self._witness_program = (
                DeviceWitnessProgram(self.cs, self.n, self.device)
                if self.mesh is None and DeviceWitnessProgram.supported(self.cs)
                else None)
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
        raises ValueError there). A sharded prover takes the host transcript,
        replicated on every rank (True raises). ``verbose`` prints the
        stage split (each stage ends in a device sync); ``on_stage(label)``,
        if given, is called at the end of each stage of that split, after
        the sync and outside the stages' times (`chip_smoke.py` profiles
        each stage through it)."""
        cs = self.cs
        cfg = self.cfg
        mesh = self.mesh
        _check_supported(hasher, mesh)
        dev = self.device
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
        # the base-domain rows of this prover: all n, or the rank's block
        rows = n if mesh is None else n // mesh.size

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
            if mesh is not None:
                return ShardedOracle(mesh, cols, lde, cap_size, hasher,
                                     tree_lde=tree_lde, monomials=monomials)
            return DeviceOracle(cols, lde, cap_size, hasher,
                                tree_lde=tree_lde, monomials=monomials,
                                device=dev)

        if mesh is not None:
            from ..parallel.sharded_oracle import (
                ShardedOracle, eval_monomial_sets_at as sharded_evals,
                sharded_monomials_to_lde, sharded_quotient_monomials)
            from ..parallel.sharding import distributed_grand_product
            if device_transcript:
                raise ValueError("a sharded prove takes the host transcript")
        eligible = (mesh is None
                    and transcript_kind in ("poseidon", "poseidon2")
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
        stage("witness oracle")

        # -- stages 2+3: copy-permutation z and partial products, lookup A/B
        # polys: one (rows, 2·k2) matrix of the oracles' Lagrange values
        beta = ext_challenge()
        gamma = ext_challenge()
        x_vals = tables["x_vals"]
        non_res = tables["non_res"]
        num_intermediates = -(-num_var_polys // qd) - 1
        num_lookup_subargs = lp.num_sublookup_arguments_for_geometry(geometry)
        lookup = None
        if lp.lookup_is_allowed:
            lookup_beta = ext_challenge()
            lookup_gamma = ext_challenge()
            width = lp.lookup_width()
            if lp.is_specialized:
                pw = lp.specialized_columns_per_repetition()
                base_off = geometry.num_columns_under_copy_permutation
            else:
                pw = lp.columns_per_subargument()  # the id column included
                base_off = 0
            tid_cols = sb.table_ids_column_idxes
            lookup = stage23.LookupInputs(
                beta=lookup_beta,
                gamma_pows=ext_pow_list(lookup_gamma, width + 1),
                width=width, pw=pw, base_off=base_off,
                num_subargs=num_lookup_subargs,
                tid_cols=tuple(num_sigma_polys + t for t in tid_cols)
                if lp.id_in_constant else (),
                table_off=num_sigma_polys + num_const_polys,
                num_table=num_table_polys,
                mult_col=num_var_polys + num_wit_polys,
                sel=None if lp.is_specialized else tables["sel_base"])

        if mesh is None:
            stage2_lagrange = stage23.stage23(
                witness_oracle.lagrange, setup_oracle.lagrange, x_vals,
                non_res, beta, gamma, qd, lookup)
        else:
            stage2_lagrange = stage23.stage23_ops(
                witness_oracle.lagrange, setup_oracle.lagrange, x_vals,
                non_res, beta, gamma, qd, lookup,
                lambda r: distributed_grand_product(mesh, r))
        stage("stages 2+3")

        # -- stage 4: stage-2 oracle -------------------------------------------
        stage2_oracle = oracle(stage2_lagrange, used_lde, tree_lde=fri_lde)
        del stage2_lagrange
        absorb_cap(stage2_oracle)
        stage("stage-2 oracle")

        # -- stage 5: alpha (the sweep makes its powers) ------------------------
        alpha = ext_challenge()
        layout = tables["quotient"]

        # -- stage 6: quotient over the flat (qd·n) domain, divided by the
        # vanishing poly: z(x·ω) from its monomials c_k·ω^k by a qd-coset
        # LDE, then one kernel launch (the sharded prove: over the rank's
        # coset-major blocks)
        z_shift_mono = gl.mul(stage2_oracle.monomials[:, 0:2], x_vals[:, None])
        zs = (dops.monomials_to_lde(z_shift_mono, qd) if mesh is None
              else sharded_monomials_to_lde(mesh, z_shift_mono, qd))  # (qd, n, 2)
        challenges = quotient.Challenges(
            beta, gamma, lookup.beta if lookup else None,
            lookup.gamma_pows if lookup else None, alpha)
        q2 = quotient.quotient_sweep(
            layout, witness_oracle.flat_t, setup_oracle.flat_t,
            stage2_oracle.flat_t, tables["x_lde"], tables["l1"],
            zs.reshape(qd * rows, 2), tables["vanish_inv"], non_res,
            challenges, tables.get("sel_flat"),
            program=tables["quotient_program"])
        del zs
        stage("quotient sweep")

        # -- stage 7: coset iNTT, chunk ----------------------------------------
        if mesh is None:
            g = gl.MULTIPLICATIVE_GENERATOR
            if (qd * n).bit_length() - 1 >= 14:
                q_mono = ntt.coset_intt_fourstep_cols(q2, g)
            else:
                q_mono = ntt.coset_intt_cols(
                    q2, g, ntt.get_plan((qd * n).bit_length() - 1))
            del q2
            # chunk k of component c -> monomial column 2k + c, (n, 2·qd)
            quotient_monomials = q_mono.reshape(qd, n, 2).permute(1, 0, 2) \
                .reshape(n, 2 * qd).contiguous()
            del q_mono
        else:
            quotient_monomials = sharded_quotient_monomials(
                mesh, (q2[:, 0], q2[:, 1]), qd)
            del q2
        # the quotient's top coefficient is zero for a satisfied circuit; it
        # is checked on the host at the next fetch (the evaluations', or the
        # device transcript's handoff), not with a wait of its own. Under a
        # mesh the last rank holds it, and the evaluations' sum brings it
        # to every rank.
        q_top = None
        if cs.config.runtime_asserts:
            q_top = quotient_monomials[-1:, -2:].clone()
            if mesh is not None and mesh.rank != mesh.size - 1:
                q_top.zero_()

        def check_quotient_top(top):
            if top[0] or top[1]:
                cs.check_if_satisfied(verbose=True)
                raise AssertionError("unsatisfied circuit (see row report above)")
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
        sets = [(w_mono, z_pt), (s_mono, z_pt), (st2_mono, z_pt),
                (q_mono_t, z_pt), (st2_mono[:, 0:2], zw)]
        row0 = st2_mono[0]  # the constant coefficients
        if mesh is None:
            (w_z, s_z, st2_z, q_z, st2_zw) = eval_monomial_sets_at(sets)
        else:
            # rank 0 holds the constant coefficients and the last rank the
            # quotient's top one: both ride the sum of the evaluations
            extra = [row0 * int(mesh.rank == 0)]
            extra += [] if q_top is None else [q_top.reshape(-1)]
            (w_z, s_z, st2_z, q_z, st2_zw, row0, *top) = sharded_evals(
                mesh, sets, extra)
            if q_top is not None:
                q_top = top[0].reshape(1, 2)

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
        a_off, b_off = layout.a_off, layout.b_off
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
        ch_iter = iter(ext_pow_list(deep, total_ch))

        fsize = fri_lde * rows
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
                                   cap_size, tables["roots"], hasher, mesh)
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
        coll = FetchCollector(mesh)
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
