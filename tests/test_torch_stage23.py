"""Stages 2 and 3 of the port's prove (`prover/stage23.py`): the plain
version against the JAX reference, and a Python-int emulation of the two
Hopper kernels of `csrc/stage23.cu` against the plain version.

The reference is the JAX `DeviceProver`'s op-by-op stages 2 and 3 (its
mesh branch, `boojum_tpu/prover/device_prover.py:852-908`, on the jitted
primitives of `boojum_tpu/prover/jit_ops.py`) with the single-device grand
product `jgrand_product_exclusive`: its one compiled program `_stage23_jit`
(:1704) computes the same values (its docstring: bit-identical) but takes
about 100 s to compile on XLA:CPU for one small case. Inputs come from a
numpy seed; every comparison is exact.

The emulation runs the kernels' indexing on flat Python-int arrays: the
parameter array the wrapper packs (`stage23.row_params`, read in the C
struct's order), the scalar array (`stage23._scalars`), the witness and
setup rows at their row strides, the output's z and partial columns as the
row kernel's scratch, every inverse by the kernels' addition chain
(`stage23.inverse_chain`, zeros included), and the scan's three phases
(block products, the one-block scan of them SCAN_BLOCK at a time with a
carry, the per-block Hillis-Steele scan and the partials) at block sizes
below, equal to and above n. It is the only check of the kernels' indexing
that runs without a card; change a kernel, change its emulation first."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from boojum_tpu.prover import jit_ops as ref_ops
from boojum_tpu_torch.field import extension as ext2
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.prover import stage23

P = gl.ORDER

# name -> (n, num_var, qd, lookup mode, id columns, zero rows)
# lookup mode: None, "specialized" (pw = width columns after the copy
# columns, the table id in a constant column: one per repetition, or one
# shared) or "general" (pw = width + 1 columns from column 0, the marker's
# selector); zero rows: a lookup aggregate, the table aggregate and a
# copy-permutation denominator made zero on rows 5, 7 and 9
CASES = {
    "no_lookup": (64, 12, 4, None, 0, False),
    "specialized_id_in_constant": (64, 14, 4, "specialized", 2, False),
    "general_with_sel": (128, 16, 4, "general", 0, False),
    "padded_chunk": (64, 11, 4, "specialized", 1, False),
    "zero_aggregate": (256, 14, 4, "specialized", 1, True),
}
WIDTH = 3
NUM_SUBARGS = 2
NUM_WIT = 2  # witness columns between the variables and the multiplicity


def _rand(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def _rand_ext(rng):
    return tuple(int(v) for v in _rand(rng, 2))


@functools.lru_cache(maxsize=None)
def make_case(name):
    """The inputs of one case (`stage23.random_inputs`) as host arrays and
    Python ints: witness (n, kw) = variables, NUM_WIT witness columns,
    multiplicity; setup (n, ks) = sigma, constants (table ids, if any,
    first), tables."""
    n, nv, qd, mode, ntid, zeros = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 23)
    nconst = ntid + 1
    ntab = WIDTH + 1 if mode else 0
    lk = None
    if mode:
        if mode == "specialized":
            pw, base_off = WIDTH, nv - NUM_SUBARGS * WIDTH
        else:
            pw, base_off = WIDTH + 1, 0
        lk = dict(width=WIDTH, pw=pw, base_off=base_off,
                  num_subargs=NUM_SUBARGS,
                  tid_cols=tuple(range(nv, nv + ntid)), table_off=nv + nconst,
                  num_table=ntab, mult_col=nv + NUM_WIT,
                  sel=mode == "general")
    inputs = stage23.random_inputs(rng, n, nv, qd, nv + NUM_WIT + 1,
                                   nv + nconst + ntab, lk,
                                   (5, 7, 9) if zeros else None)
    return dict(inputs, n=n, nv=nv)


def _lookup_inputs(case):
    return stage23.args_on(case, "cpu")[7]


def port_plain(case, wit=None):
    """`stage23` on CPU tensors (its plain version)."""
    args = stage23.args_on(case, "cpu")
    if wit is not None:
        args = (wit,) + args[1:]
    return gl.to_u64(stage23.stage23(*args))


# ---------------------------------------------------------------------------
# The JAX reference (boojum_tpu/prover/device_prover.py:852-908)
# ---------------------------------------------------------------------------


def _lohi(a):
    a = np.asarray(a, np.uint64)
    return (jnp.asarray((a & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((a >> np.uint64(32)).astype(np.uint32)))


def jax_stage23(case):
    """The reference's stages 2 and 3 on the case -> (n, 2·k2) u64."""
    EV, scalar_ext = ref_ops.EV, ref_ops.scalar_ext
    n, nv, qd = case["n"], case["nv"], case["qd"]
    wit, setup, lk = case["wit"], case["setup"], case["lookup"]
    beta_a, gamma_a = scalar_ext(case["beta"]), scalar_ext(case["gamma"])
    x_lo, x_hi = _lohi(case["x_vals"])

    def col(m, j):
        return _lohi(m[:, j])

    chunks = []
    for c in range(-(-nv // qd)):
        num_acc = EV.const((1, 0), (n,))
        den_acc = EV.const((1, 0), (n,))
        for j in range(c * qd, min((c + 1) * qd, nv)):
            w_lo, w_hi = col(wit, j)
            nr = scalar_ext((case["non_res"][j], 0))
            bx_lo, bx_hi = ref_ops.jbase_mul(
                x_lo, x_hi, jnp.broadcast_to(jnp.uint32(nr[0, 0]), (n,)),
                jnp.broadcast_to(jnp.uint32(nr[0, 1]), (n,)))
            num_j = EV(*ref_ops.jaffine(w_lo, w_hi, bx_lo, bx_hi, beta_a,
                                        gamma_a))
            s_lo, s_hi = col(setup, j)
            den_j = EV(*ref_ops.jaffine(w_lo, w_hi, s_lo, s_hi, beta_a,
                                        gamma_a))
            num_acc = num_acc * num_j
            den_acc = den_acc * den_j
        chunks.append(num_acc * den_acc.inv())
    total = chunks[0]
    for c in chunks[1:]:
        total = total * c
    z_ev = EV(*ref_ops.jgrand_product_exclusive(*total.a))
    evs = [z_ev]
    prev = z_ev
    for c in chunks[:-1]:
        prev = prev * c
        evs.append(prev)
    if lk is not None:
        gpow_a = [scalar_ext(c) for c in lk["gamma_pows"]]
        for rep in range(lk["num_subargs"]):
            agg = EV.const(lk["beta"], (n,))
            for i in range(lk["pw"]):
                w_lo, w_hi = col(wit, lk["base_off"] + rep * lk["pw"] + i)
                agg = agg + EV(*ref_ops.jscale_base(w_lo, w_hi, gpow_a[i]))
            if lk["tid_cols"]:
                ntid = len(lk["tid_cols"])
                t_lo, t_hi = col(setup, lk["tid_cols"][min(rep, ntid - 1)])
                agg = agg + EV(*ref_ops.jscale_base(t_lo, t_hi,
                                                    gpow_a[lk["width"]]))
            a_ev = agg.inv()
            if lk["sel"] is not None:
                a_ev = a_ev.mul_base(*_lohi(lk["sel"]))
            evs.append(a_ev)
        agg_t = EV.const(lk["beta"], (n,))
        for i in range(lk["num_table"]):
            t_lo, t_hi = col(setup, lk["table_off"] + i)
            agg_t = agg_t + EV(*ref_ops.jscale_base(t_lo, t_hi, gpow_a[i]))
        m_lo, m_hi = col(wit, lk["mult_col"])
        evs.append(agg_t.inv().mul_base(m_lo, m_hi))
    cols = []
    for ev in evs:
        c0, c1 = ev.to_host()
        cols += [c0, c1]
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_jax_reference(name):
    case = make_case(name)
    got = port_plain(case)
    want = jax_stage23(case)
    assert got.shape == (case["n"], stage23.num_columns(
        case["nv"], case["qd"], _lookup_inputs(case)))
    np.testing.assert_array_equal(got, want)
    if CASES[name][5]:  # the zero rows show
        g = -(-case["nv"] // case["qd"])
        assert got[5, 2 * g] == got[5, 2 * g + 1] == 0
        assert got[7, -2] == got[7, -1] == 0
        assert not got[10:, :2].any() and got[9, :2].any()


# ---------------------------------------------------------------------------
# Emulation of csrc/stage23.cu
# ---------------------------------------------------------------------------


def e2_mul(a, b):
    v0, v1 = a[0] * b[0] % P, a[1] * b[1] % P
    return ((v0 + v1 * 7) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def e2_inv(a):
    norm = (a[0] * a[0] - a[1] * a[1] % P * 7) % P
    inv = stage23.inverse_chain(norm)
    return (a[0] * inv % P, (-(a[1] * inv)) % P)


def emulate_rows(wit, setup, x, nonres, scal, sel, q):
    """The row kernel over flat arrays; ``q`` the parameter array, read as
    the C launcher reads it. Returns the flat output (n · ldo)."""
    n, nv, qd, ldw, lds, ldo, lookup, nsub, pw, base_off, width, ntid, \
        table_off, ntab, mult_col = q[:15]
    tid = q[15:]
    assert len(tid) == stage23.MAX_TID
    out = [None] * (n * ldo)
    beta, gamma = (scal[0], scal[1]), (scal[2], scal[3])
    chunks = (nv + qd - 1) // qd
    for i in range(n):
        w, s, o = i * ldw, i * lds, i * ldo

        def affine(wj, sj):
            return ((wj + sj * beta[0] + gamma[0]) % P,
                    (sj * beta[1] + gamma[1]) % P)

        total = (1, 0)
        for c in range(chunks):
            num = den = (1, 0)
            for j in range(c * qd, min((c + 1) * qd, nv)):
                wj = wit[w + j]
                num = e2_mul(num, affine(wj, x[i] * nonres[j] % P))
                den = e2_mul(den, affine(wj, setup[s + j]))
            r = e2_mul(num, e2_inv(den))
            total = e2_mul(total, r)
            if c + 1 < chunks:
                out[o + 2 + 2 * c], out[o + 3 + 2 * c] = r
        out[o], out[o + 1] = total
        if not lookup:
            continue
        lbeta, gp = (scal[4], scal[5]), scal[6:]

        def add_scaled(acc, b, t):
            return ((acc[0] + b * gp[2 * t]) % P,
                    (acc[1] + b * gp[2 * t + 1]) % P)

        oa = o + 2 * chunks
        for rep in range(nsub):
            agg = lbeta
            for t in range(pw):
                agg = add_scaled(agg, wit[w + base_off + rep * pw + t], t)
            if ntid:
                agg = add_scaled(agg, setup[s + tid[min(rep, ntid - 1)]],
                                 width)
            a = e2_inv(agg)
            if sel is not None:
                a = (a[0] * sel[i] % P, a[1] * sel[i] % P)
            out[oa + 2 * rep], out[oa + 2 * rep + 1] = a
        agg = lbeta
        for t in range(ntab):
            agg = add_scaled(agg, setup[s + table_off + t], t)
        b = e2_inv(agg)
        m = wit[w + mult_col]
        out[oa + 2 * nsub], out[oa + 2 * nsub + 1] = (b[0] * m % P,
                                                       b[1] * m % P)
    return out


def _inclusive_scan(vals):
    """The shared-memory Hillis-Steele scan of one block: at each step
    every thread reads its partner's value of the step before (the barrier
    between the read and the write)."""
    sh = list(vals)
    d = 1
    while d < len(sh):
        sh = [e2_mul(sh[t - d], sh[t]) if t >= d else e2_mul((1, 0), sh[t])
              for t in range(len(sh))]
        d <<= 1
    return sh


def emulate_scan(out, n, chunks, ldo, block):
    """stage23_scan over the flat output, in place; returns its launches."""
    nb = (n + block - 1) // block

    def total(i):
        return (out[i * ldo], out[i * ldo + 1]) if i < n else (1, 0)

    prefix = None
    if nb > 1:
        prods = []
        for b in range(nb):  # phase 1: a tree product of each block
            sh = [total(b * block + t) for t in range(block)]
            h = block // 2
            while h:
                sh = [e2_mul(sh[t], sh[t + h]) if t < h else sh[t]
                      for t in range(block)]
                h //= 2
            prods.append(sh[0])
        carry = (1, 0)  # phase 2: one block, `block` products at a time
        for base in range(0, nb, block):
            sh = _inclusive_scan([prods[base + t] if base + t < nb else (1, 0)
                                  for t in range(block)])
            excl = [e2_mul(carry, sh[t - 1] if t else (1, 0))
                    for t in range(block)]
            for t in range(block):
                if base + t < nb:
                    prods[base + t] = excl[t]
            carry = e2_mul(carry, sh[block - 1])
        prefix = prods
    for b in range(nb):  # phase 3
        sh = _inclusive_scan([total(b * block + t) for t in range(block)])
        for t in range(block):
            i = b * block + t
            if i >= n:
                break
            z = sh[t - 1] if t else (1, 0)
            if prefix is not None:
                z = e2_mul(prefix[b], z)
            o = i * ldo
            out[o], out[o + 1] = z
            part = z
            for c in range(chunks - 1):
                part = e2_mul(part, (out[o + 2 + 2 * c], out[o + 3 + 2 * c]))
                out[o + 2 + 2 * c], out[o + 3 + 2 * c] = part
    return 1 if nb == 1 else 3


def emulate(case, block, pad=0):
    """Both kernels on the case, the witness as a view with ``pad`` more
    columns a row (its row stride) -> (n, ldo) u64 and the scan's launches."""
    n, nv, qd = case["n"], case["nv"], case["qd"]
    wide = np.concatenate([case["wit"], np.zeros((n, pad), np.uint64)], 1)
    wit_t = gl.from_u64(wide)[:, :case["wit"].shape[1]]
    lk = _lookup_inputs(case)
    q = stage23.row_params(n, nv, qd, wit_t.stride(0), case["setup"].shape[1],
                           lk, wit_t.shape[1], case["setup"].shape[1])
    scal = [case["beta"], case["gamma"]]
    if lk is not None:
        scal += [lk.beta] + list(lk.gamma_pows)
    scal = [int(v) for v in gl.to_u64(stage23._scalars(scal, "cpu"))]
    out = emulate_rows([int(v) for v in wide.reshape(-1)],
                       [int(v) for v in case["setup"].reshape(-1)],
                       [int(v) for v in case["x_vals"]], case["non_res"], scal,
                       None if lk is None or lk.sel is None
                       else [int(v) for v in case["lookup"]["sel"]], q)
    ldo = q[5]
    launches = emulate_scan(out, n, -(-nv // qd), ldo, block)
    return np.asarray(out, np.uint64).reshape(n, ldo), launches


@pytest.mark.parametrize("name,block", [
    ("zero_aggregate", 4),        # 64 blocks: phase 2 in 16 chunks
    ("zero_aggregate", 16),       # 16 blocks, one phase-2 chunk
    ("zero_aggregate", 256),      # n equal to the block: one launch
    ("general_with_sel", 32),
    ("general_with_sel", 512),    # n below the block
    ("no_lookup", 8),
    ("padded_chunk", 64),
    ("specialized_id_in_constant", 16),
])
def test_kernel_emulation_matches_plain(name, block):
    case = make_case(name)
    got, launches = emulate(case, block, pad=3)
    np.testing.assert_array_equal(got, port_plain(case))
    assert launches == (1 if case["n"] <= block else 3)
    if block == stage23.SCAN_BLOCK:
        assert launches == stage23.scan_launches(case["n"])


def test_plain_on_a_strided_witness():
    # the prover hands the oracles' Lagrange tensors over as they are
    case = make_case("specialized_id_in_constant")
    wide = np.concatenate([case["wit"], _rand(np.random.default_rng(1),
                                              case["n"], 5)], 1)
    view = gl.from_u64(wide)[:, :case["wit"].shape[1]]
    assert view.stride(0) != view.shape[1]
    np.testing.assert_array_equal(port_plain(case, view), port_plain(case))


def test_inverse_chain():
    rng = np.random.default_rng(5)
    for v in [0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1] + [
            int(x) for x in _rand(rng, 20)]:
        assert stage23.inverse_chain(v) == pow(v, P - 2, P)
    steps = stage23.INVERSE_CHAIN
    assert sum(k for _, _, k, _ in steps) == 63 and len(steps) == 9


def test_scalars_host_and_device_forms_agree():
    # host pairs go through a pinned upload, device scalars through a stack
    rng = np.random.default_rng(3)
    pairs = [_rand_ext(rng) for _ in range(5)]
    prepared = ext2.prepare(gl.from_u64(np.asarray(pairs, np.uint64)))
    want = np.asarray([c for p in pairs for c in p], np.uint64)
    np.testing.assert_array_equal(gl.to_u64(stage23._scalars(pairs, "cpu")),
                                  want)
    np.testing.assert_array_equal(
        gl.to_u64(stage23._scalars(prepared, "cpu")), want)


def test_row_params_layout_and_checks():
    case = make_case("specialized_id_in_constant")
    lk = _lookup_inputs(case)
    kw, ks = case["wit"].shape[1], case["setup"].shape[1]
    q = stage23.row_params(64, 14, 4, kw + 1, ks, lk, kw, ks)
    assert len(q) == 15 + stage23.MAX_TID
    assert q[:15] == [64, 14, 4, kw + 1, ks, stage23.num_columns(14, 4, lk),
                      1, NUM_SUBARGS, WIDTH, 14 - NUM_SUBARGS * WIDTH, WIDTH,
                      2, lk.table_off, lk.num_table, lk.mult_col]
    assert q[15:17] == list(lk.tid_cols) and not any(q[17:])
    assert stage23.row_params(64, 14, 4, kw, ks, None, kw, ks)[6:15] == \
        [0] * 9
    with pytest.raises(ValueError):  # the multiplicity outside the witness
        stage23.row_params(64, 14, 4, kw, ks, lk, lk.mult_col, ks)
    with pytest.raises(ValueError):  # a table column outside the setup
        stage23.row_params(64, 14, 4, kw, ks, lk, kw, ks - 1)


def test_other_devices_raise():
    # a tensor on another device type is refused, never computed plainly
    case = make_case("no_lookup")
    wit = gl.from_u64(case["wit"]).to("meta")
    with pytest.raises(RuntimeError):
        stage23.stage23(wit, gl.from_u64(case["setup"]).to("meta"),
                        gl.from_u64(case["x_vals"]).to("meta"),
                        stage23.NonResidues.make(case["non_res"], "cpu"),
                        case["beta"], case["gamma"], case["qd"])
