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
struct's order, the launcher's derived lane count and build), the scalar
array (`stage23._scalars`), the witness and setup rows staged a warp at a
time at their row strides, the lanes' slots, the warp shuffles as index
maps within each row's lanes, the masked batch inversion (one
`stage23.inverse_chain` a row, counted), the 16-byte stores into the
output's z and partial columns as the row kernel's scratch; then the
scan's tiles by ticket, each block's warp scans, the decoupled look-back
over the status words (flags tagged with the call's epoch) in several
orders of the tiles' steps, and the partials staged SCAN_COLS columns at a
time. Tiles smaller than the kernel's (fewer threads a block) give several
tiles at small n, and more than one look-back window. It is the only check of the kernels' indexing that runs
without a card; change a kernel, change its emulation first."""

import functools
import os
import re

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


def _cu_constants():
    """The integer constants of csrc/stage23.cu by name."""
    text = open(os.path.join(os.path.dirname(stage23.__file__), "..", "csrc",
                             "stage23.cu")).read()
    consts = {}
    for decl in re.findall(r"constexpr (?:int|uint64_t) ([^;]+);", text):
        for part in decl.split(","):
            name, value = (v.strip() for v in part.split("="))
            consts[name] = eval(value.replace("/", "//"), {},
                                dict(consts))
    return consts


CU = _cu_constants()
ROW_WARPS, SCAN_COLS = CU["ROW_WARPS"], CU["SCAN_COLS"]
assert CU["SCAN_STRIDE"] % 2 == 1  # a warp's 64-bit reads: 32 banks apiece


def e2_mul(a, b):  # Karatsuba, as the kernels
    v0, v1 = a[0] * b[0] % P, a[1] * b[1] % P
    s = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((v0 + 7 * v1) % P, (s - v0 - v1) % P)


def e2_mul_conj(a, b):
    v0, v1 = a[0] * b[0] % P, a[1] * b[1] % P
    s = (a[0] + a[1]) * (b[0] - b[1]) % P
    return ((v0 - 7 * v1) % P, (s - v0 + v1) % P)


def e2_norm(a):
    return (a[0] * a[0] - 7 * a[1] * a[1]) % P


def _shfl(vals, lane, src_in_segment, width):
    """Lane ``lane``'s read of a shuffle over segments of ``width`` lanes."""
    base = lane & ~(width - 1)
    return vals[base + src_in_segment]


def shfl_up(vals, d, width):
    return [_shfl(vals, l, (l % width) - d if l % width >= d else l % width,
                  width) for l in range(32)]


def shfl_down(vals, d, width):
    return [_shfl(vals, l, (l % width) + d if l % width + d < width
                  else l % width, width) for l in range(32)]


def shfl_xor(vals, m, width):
    return [_shfl(vals, l, (l % width) ^ m, width) for l in range(32)]


def shfl_idx(vals, src, width):
    return [_shfl(vals, l, src % width, width) for l in range(32)]


def row_launch(q):
    """The launcher's derived fields: chunks, inverses, staged columns,
    the build's slots a lane, log2 of the lanes a row."""
    n, nv, qd, ldw, lds, ldo, lookup, nsub, pw, base_off, width, ntid, \
        table_off, ntab, mult_col = q[:15]
    tid = q[15:]
    chunks = -(-nv // qd)
    inverses = chunks + (nsub + 1 if lookup else 0)
    wcols = scols = nv
    if lookup:
        wcols = max(wcols, base_off + nsub * pw, mult_col + 1)
        scols = max([scols, table_off + ntab] + [t + 1 for t in tid[:ntid]])
    assert 2 * inverses == ldo and wcols <= ldw and scols <= lds
    rounds = CU["ROUNDS_SMALL"] if inverses <= 32 * CU["ROUNDS_SMALL"] \
        else CU["ROUNDS_LARGE"]
    assert inverses <= 32 * rounds
    log_lanes = 0
    while (1 << log_lanes) * rounds < inverses:
        log_lanes += 1
    return chunks, inverses, wcols, scols, rounds, log_lanes


def emulate_rows(wit, setup, x, nonres, scal, sel, q, stats):
    """The row kernel over flat arrays; ``q`` the parameter array, read as
    the C launcher reads it. Returns the flat output (n · ldo); ``stats``
    counts the Fermat chains (one a row; a warp's rows in one pass)."""
    n, nv, qd, ldw, lds, ldo, lookup, nsub, pw, base_off, width, ntid, \
        table_off, ntab, mult_col = q[:15]
    tid = q[15:]
    assert len(tid) == stage23.MAX_TID
    chunks, inverses, wcols, scols, rounds, log_lanes = row_launch(q)
    L, rows = 1 << log_lanes, 32 >> log_lanes
    beta, gamma = (scal[0], scal[1]), (scal[2], scal[3])
    lbeta, g = (scal[4], scal[5]) if lookup else None, scal[6:]
    out = [None] * (n * ldo)

    # β·k_j a copy column, in the block's shared memory
    bk = [(beta[0] * k % P, beta[1] * k % P) for k in nonres]

    def affine(wj, sj, b):
        return ((wj + sj * b[0] + gamma[0]) % P, (sj * b[1] + gamma[1]) % P)

    def slot_value(k, w, s, xi, selv):
        if k < chunks:  # w + (β·k_j)·x + γ over w + β·σ_j + γ
            start, end = k * qd, min(k * qd + qd, nv)
            num = affine(w[start], xi, bk[start])
            den = affine(w[start], s[start], beta)
            for j in range(start + 1, end):
                num = e2_mul(num, affine(w[j], xi, bk[j]))
                den = e2_mul(den, affine(w[j], s[j], beta))
            return e2_mul_conj(num, den), e2_norm(den)
        rep = k - chunks
        table = rep == nsub
        src = [s[table_off + t] for t in range(ntab)] if table else \
            [w[base_off + rep * pw + t] for t in range(pw)]
        agg = lbeta
        for t, b in enumerate(src):
            agg = ((agg[0] + b * g[2 * t]) % P,
                   (agg[1] + b * g[2 * t + 1]) % P)
        if not table and ntid:
            b = s[tid[min(rep, ntid - 1)]]
            agg = ((agg[0] + b * g[2 * width]) % P,
                   (agg[1] + b * g[2 * width + 1]) % P)
        v = (agg[0], -agg[1] % P)
        f = w[mult_col] if table else selv
        if f is not None:
            v = (v[0] * f % P, v[1] * f % P)
        return v, e2_norm(agg)

    for blk in range(-(-n // (ROW_WARPS * rows))):
        for warp in range(ROW_WARPS):
            i0 = (blk * ROW_WARPS + warp) * rows
            if i0 >= n:
                continue
            # staging: lane c % 32 copies column c of each row below n
            sw, ss = [None] * (rows * wcols), [None] * (rows * scols)
            for buf, src, cols, ld in ((sw, wit, wcols, ldw),
                                       (ss, setup, scols, lds)):
                for r in range(rows):
                    if i0 + r >= n:
                        break
                    for lane in range(32):
                        for c in range(lane, cols, 32):
                            buf[r * cols + c] = src[(i0 + r) * ld + c]
            lanes = []
            for lane in range(32):
                li, rr = lane & (L - 1), lane >> log_lanes
                i = i0 + rr
                live = i < n
                w, s = sw[rr * wcols:], ss[rr * scols:]
                v, norm, before, prod = [], [], [], 1
                for r in range(rounds):
                    k = r * L + li
                    vk, nk = (0, 0), 1
                    if live and k < inverses:
                        vk, nk = slot_value(k, w, s, x[i],
                                            sel[i] if sel else None)
                        if nk == 0:
                            assert vk == (0, 0)
                            nk = 1
                    v.append(vk)
                    norm.append(nk)
                    before.append(prod)
                    prod = prod * nk % P if r else nk
                lanes.append(dict(li=li, i=i, live=live, v=v, norm=norm,
                                  before=before, prod=prod))
            pre = [ln["prod"] for ln in lanes]
            suf = list(pre)
            d = 1
            while d < L:
                a, b = shfl_up(pre, d, L), shfl_down(suf, d, L)
                pre = [pre[l] * (a[l] if lanes[l]["li"] >= d else 1) % P
                       for l in range(32)]
                suf = [suf[l] * (b[l] if lanes[l]["li"] + d < L else 1) % P
                       for l in range(32)]
                d <<= 1
            row_prod = shfl_idx(pre, L - 1, L)
            lo, hi = shfl_up(pre, 1, L), shfl_down(suf, 1, L)
            chains = {}  # row -> its one chain, run by all its lanes at once
            for l, ln in enumerate(lanes):
                if ln["i"] not in chains:
                    chains[ln["i"]] = stage23.inverse_chain(row_prod[l])
                    stats["chains"] += ln["live"]
                assert row_prod[l] * chains[ln["i"]] % P == 1
            stats["warp_passes"] += 1
            totals = []
            for l, ln in enumerate(lanes):
                li = ln["li"]
                inv = chains[ln["i"]] * (lo[l] if li else 1) % P
                inv = inv * (hi[l] if li + 1 < L else 1) % P
                total = (1, 0)
                for r in reversed(range(rounds)):
                    k = r * L + li
                    inv_k = inv * ln["before"][r] % P if r else inv
                    if r:
                        inv = inv * ln["norm"][r] % P
                    if ln["live"] and k < inverses:
                        res = (ln["v"][r][0] * inv_k % P,
                               ln["v"][r][1] * inv_k % P)
                        if k < chunks:
                            total = e2_mul(total, res)
                        if k != chunks - 1:
                            o = ln["i"] * ldo + 2 * (k + 1 if k < chunks
                                                     else k)
                            assert out[o] is None
                            out[o], out[o + 1] = res
                totals.append(total)
            d = 1
            while d < L:
                c0 = shfl_xor([t[0] for t in totals], d, L)
                c1 = shfl_xor([t[1] for t in totals], d, L)
                totals = [e2_mul(totals[l], (c0[l], c1[l]))
                          for l in range(32)]
                d <<= 1
            for l, ln in enumerate(lanes):
                if ln["live"] and ln["li"] == 0:
                    o = ln["i"] * ldo
                    assert out[o] is None
                    out[o], out[o + 1] = totals[l]
    assert None not in out
    return out


def rows_reference(case):
    """What the row kernel writes, straight from the definitions with
    Fermat inverses (0 -> 0): the total and the ratios of chunks 0..G-2 in
    the z and partial columns, then A and B."""
    n, nv, qd = case["n"], case["nv"], case["qd"]
    wit, setup, lk = case["wit"], case["setup"], case["lookup"]
    beta, gamma = case["beta"], case["gamma"]

    def inv(a):
        t = pow(e2_norm(a), P - 2, P)
        return (a[0] * t % P, -a[1] * t % P)

    def aff(w, s):
        return ((w + s * beta[0] + gamma[0]) % P, (s * beta[1] + gamma[1]) % P)

    rows = []
    for i in range(n):
        w, s = [int(v) for v in wit[i]], [int(v) for v in setup[i]]
        xi = int(case["x_vals"][i])
        ratios = []
        for c in range(0, nv, qd):
            num = den = (1, 0)
            for j in range(c, min(c + qd, nv)):
                num = e2_mul(num, aff(w[j], xi * case["non_res"][j] % P))
                den = e2_mul(den, aff(w[j], s[j]))
            ratios.append(e2_mul(num, inv(den)))
        total = (1, 0)
        for r in ratios:
            total = e2_mul(total, r)
        row = [total] + ratios[:-1]
        if lk is not None:
            g = lk["gamma_pows"]

            def agg(vals, extra=None):
                a = lk["beta"]
                for t, b in enumerate(vals):
                    a = ((a[0] + b * g[t][0]) % P, (a[1] + b * g[t][1]) % P)
                if extra is not None:
                    b, gw = extra, g[lk["width"]]
                    a = ((a[0] + b * gw[0]) % P, (a[1] + b * gw[1]) % P)
                return a

            for rep in range(lk["num_subargs"]):
                tids = lk["tid_cols"]
                a = inv(agg([w[lk["base_off"] + rep * lk["pw"] + t]
                             for t in range(lk["pw"])],
                            s[tids[min(rep, len(tids) - 1)]] if tids
                            else None))
                if lk["sel"] is not None:
                    sv = int(lk["sel"][i])
                    a = (a[0] * sv % P, a[1] * sv % P)
                row.append(a)
            b = inv(agg([s[lk["table_off"] + t]
                         for t in range(lk["num_table"])]))
            m = w[lk["mult_col"]]
            row.append((b[0] * m % P, b[1] * m % P))
        rows.append([c for pair in row for c in pair])
    return np.asarray(rows, np.uint64)


def emulate_scan(out, n, chunks, ldo, threads, status, epoch, order):
    """stage23_scan over the flat output, in place, with blocks of
    ``threads`` threads, a row each (the kernel: SCAN_THREADS; fewer make
    more tiles at small n). The tiles run as interleaved steps: ``order``
    "ticket" runs each tile to its end in ticket order, "reverse" always
    steps the highest runnable tile, "random" a random one (a seed).
    ``status`` is the flat status words (the counter first). Returns the
    launches, the aggregates the look-backs read and the look-back windows
    past each tile's first."""
    tiles = -(-n // threads)
    head, words = CU["STATUS_HEAD"], CU["STATUS_WORDS"]
    agg_flag, incl_flag = CU["FLAG_AGGREGATE"], CU["FLAG_INCLUSIVE"]
    look = CU["LOOK_TILES"]
    assert len(status) >= head + words * tiles
    width = 2 * chunks
    read = {"aggregates": 0, "windows": 0}

    def stage(row0, wsize, c0):
        # a warp's stage: columns [c0, c0 + SCAN_COLS) of its rows below n
        cw = min(SCAN_COLS, width - c0)
        buf = {}
        for f in range(32 * SCAN_COLS):
            r, c = divmod(f, SCAN_COLS)
            if c < cw and r < wsize and row0 + r < n:
                buf[r, c] = out[(row0 + r) * ldo + c0 + c]
        return buf

    def block():
        ticket = status[0]
        status[0] += 1
        if ticket == tiles - 1:
            status[0] = 0
        tile = ticket
        yield True
        warps = [(tile * threads + w0, min(32, threads - w0))
                 for w0 in range(0, threads, 32)]
        first = [stage(row0, wsize, 0) for row0, wsize in warps]
        # each warp's inclusive scan of its rows' totals (the first stage's
        # columns 0, 1)
        excl, warp_prefix = [], []
        for (row0, wsize), buf in zip(warps, first):
            incl = [(buf[l, 0], buf[l, 1]) if (l, 0) in buf else (1, 0)
                    for l in range(wsize)]
            d = 1
            while d < wsize:
                incl = [e2_mul(incl[l - d], incl[l]) if l >= d else incl[l]
                        for l in range(wsize)]
                d <<= 1
            excl.append([(1, 0)] + incl[:-1])
            warp_prefix.append(incl[-1])
        agg = (1, 0)
        for w in range(len(warp_prefix)):
            warp_prefix[w], agg = agg, e2_mul(agg, warp_prefix[w])
        # warp 0's look-back: lane 0 publishes the aggregate; the lanes
        # read a window of the 32 * LOOK_TILES tiles below ``end``,
        # LOOK_TILES each (waiting for each tile's flag of this epoch),
        # multiply from the nearest inclusive prefix up, and move the
        # window down until they meet one
        st = head + tile * words
        prefix = (1, 0)
        if tile > 0:
            status[st + 1], status[st + 2] = agg
            status[st] = epoch << 2 | agg_flag
            yield True
            end = tile
            while True:
                mine = []  # each lane's nearest inclusive prefix, or -1
                for lane in range(32):
                    q0 = end - 32 * look + lane * look
                    m = -1
                    for k in range(look):
                        if q0 + k < 0:
                            continue
                        while status[head + (q0 + k) * words] >> 2 != epoch:
                            yield False  # waits
                        if status[head + (q0 + k) * words] & 3 == incl_flag:
                            m = k
                    mine.append(m)
                incl = any(m >= 0 for m in mine)
                top = max(lane for lane in range(32) if mine[lane] >= 0) \
                    if incl else 0
                vals = []
                for lane in range(32):
                    q0 = end - 32 * look + lane * look
                    v = (1, 0)
                    for k in range(look):
                        if lane < top or q0 + k < 0 or (
                                lane == top and k < mine[lane]):
                            continue
                        at = 3 if lane == top and k == mine[lane] else 1
                        sq = head + (q0 + k) * words
                        v = e2_mul(v, (status[sq + at], status[sq + at + 1]))
                        read["aggregates"] += at == 1
                    vals.append(v)
                d = 1
                while d < 32:  # the warp's butterfly
                    vals = [e2_mul(vals[lane], vals[lane ^ d])
                            for lane in range(32)]
                    d <<= 1
                assert len(set(vals)) == 1
                prefix = e2_mul(vals[0], prefix)
                if incl:
                    break
                end -= 32 * look
                read["windows"] += 1
                yield True
        status[st + 3], status[st + 4] = e2_mul(prefix, agg)
        status[st] = epoch << 2 | incl_flag
        yield True
        # z, then the partials, SCAN_COLS u64 columns of a warp's rows at a
        # time through its stage buffers
        for w, ((row0, wsize), buf) in enumerate(zip(warps, first)):
            part = [e2_mul(e2_mul(prefix, warp_prefix[w]), excl[w][l])
                    for l in range(wsize)]
            for c0 in range(0, width, SCAN_COLS):
                if c0:
                    buf = stage(row0, wsize, c0)
                for l in range(wsize):
                    for c in range(0, min(SCAN_COLS, width - c0), 2):
                        if (l, c) not in buf:
                            continue  # a row past n
                        if c0 + c:
                            part[l] = e2_mul(part[l], (buf[l, c],
                                                       buf[l, c + 1]))
                        buf[l, c], buf[l, c + 1] = part[l]
                for (r, c), val in buf.items():
                    out[(row0 + r) * ldo + c0 + c] = val

    # every block takes its ticket (all resident), then the scheduler steps
    # them: each step a tile's next status access; a waiting tile yields
    # False and the next candidate is tried
    rng = np.random.default_rng(epoch)
    running, done = [], 0
    while done < tiles:
        if order != "ticket" or not running:
            while len(running) + done < tiles:
                gen = block()
                next(gen)  # takes its ticket
                running.append(gen)
                if order == "ticket":
                    break
        picks = {"ticket": [0], "reverse": range(len(running) - 1, -1, -1),
                 "random": rng.permutation(len(running))}[order]
        for pick in picks:
            try:
                if next(running[pick]):
                    break
            except StopIteration:
                running.pop(pick)
                done += 1
                break
        else:
            raise AssertionError("no tile can make progress")
    assert status[0] == 0
    return stage23.scan_launches(n), read["aggregates"], read["windows"]


def emulate(case, threads=CU["SCAN_THREADS"], order="random", pad=0,
            epochs=1):
    """Both kernels on the case, the witness as a view with ``pad`` more
    columns a row (its row stride) -> (n, ldo) u64, the rows kernel's own
    output, the scan's launches, aggregates read and windows past the
    first, and the chain counts.
    With ``epochs`` > 1 the scan runs again on the same status words, each
    time a new epoch over the rows kernel's output."""
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
    stats = {"chains": 0, "warp_passes": 0}
    rows_out = emulate_rows(
        [int(v) for v in wide.reshape(-1)],
        [int(v) for v in case["setup"].reshape(-1)],
        [int(v) for v in case["x_vals"]], case["non_res"], scal,
        None if lk is None or lk.sel is None
        else [int(v) for v in case["lookup"]["sel"]], q, stats)
    ldo = q[5]
    tiles = -(-n // threads)
    status = [0] * (CU["STATUS_HEAD"] + CU["STATUS_WORDS"] * tiles)
    for epoch in range(1, epochs + 1):
        out = list(rows_out)
        launches, aggregates, windows = emulate_scan(
            out, n, -(-nv // qd), ldo, threads, status, epoch, order)
    return (np.asarray(out, np.uint64).reshape(n, ldo),
            np.asarray(rows_out, np.uint64).reshape(n, ldo), launches,
            aggregates, windows, stats)


@pytest.mark.parametrize("name,threads,order", [
    ("zero_aggregate", 4, "random"),      # 64 tiles of 4 rows
    ("zero_aggregate", 1, "reverse"),     # the later tiles first; 256
    #                                       tiles of a row: 2 windows
    ("zero_aggregate", 16, "reverse"),    # 16 tiles
    ("zero_aggregate", 512, "random"),    # n = 256 below the kernel's tile
    ("general_with_sel", 64, "random"),   # 2 tiles of 64
    ("general_with_sel", 48, "reverse"),  # 48, 48 and a ragged 32; a warp
    ("no_lookup", 16, "ticket"),          # of 16 threads
    ("padded_chunk", 24, "random"),       # 24 + 24 + a ragged 16
    ("specialized_id_in_constant", 32, "reverse"),
])
def test_kernel_emulation_matches_plain(name, threads, order):
    case = make_case(name)
    got, rows_out, launches, aggregates, windows, stats = emulate(
        case, threads, order=order, pad=3, epochs=2)
    np.testing.assert_array_equal(rows_out, rows_reference(case))
    np.testing.assert_array_equal(got, port_plain(case))
    assert launches == stage23.scan_launches(case["n"]) == 1
    # one Fermat chain a row; a warp's rows run theirs in one pass
    lanes = 1 << row_launch(stage23.row_params(
        case["n"], case["nv"], case["qd"], 1 << 10, 1 << 10,
        _lookup_inputs(case), 1 << 10, 1 << 10))[5]
    assert stats["chains"] == case["n"]
    assert stats["warp_passes"] == -(-case["n"] // (32 // lanes))
    tiles = -(-case["n"] // threads)
    if order == "reverse" and tiles > 2:  # the later tiles publish first
        assert aggregates > 0  # a look-back went past an aggregate
    if order == "reverse" and tiles > 32 * CU["LOOK_TILES"] + 1:
        assert windows > 0  # and past a window


# zero inverses (slots) by row: G chunks, then the repetitions, the table
ZERO_SLOT_CASES = {
    # 4 chunks, 2 repetitions, the table: slots 0..6
    "zero_slots_specialized": ("specialized_id_in_constant", {
        3: [4], 4: [6], 5: [4, 5, 6], 40: [0], 41: [3], 42: [1, 2],
        50: list(range(7)), 51: [6]}),
    # 3 chunks, no lookups: the last slot is a denominator
    "zero_slots_no_lookup": ("no_lookup", {
        40: [0], 41: [2], 42: [0, 1, 2], 43: [1]}),
}


@functools.lru_cache(maxsize=None)
def make_zero_slot_case(name):
    base, slots = ZERO_SLOT_CASES[name]
    n, nv, qd, mode, ntid, _ = CASES[base]
    case = make_case(base)
    lk = case["lookup"]
    rng = np.random.default_rng(sorted(ZERO_SLOT_CASES).index(name) + 41)
    lookup = None
    if lk is not None:
        lookup = {k: lk[k] for k in ("width", "pw", "base_off",
                                     "num_subargs", "tid_cols", "table_off",
                                     "num_table", "mult_col")}
        lookup["sel"] = lk["sel"] is not None
    inputs = stage23.random_inputs(rng, n, nv, qd, case["wit"].shape[1],
                                   case["setup"].shape[1], lookup,
                                   zero_slots=slots)
    return dict(inputs, n=n, nv=nv)


@pytest.mark.parametrize("name", sorted(ZERO_SLOT_CASES))
def test_kernel_emulation_zero_slots(name):
    # zero norms in the first slot, the last, every slot of a row, and
    # several a row: each masked, the row's other inverses unharmed
    case = make_zero_slot_case(name)
    got, rows_out, _, _, _, stats = emulate(case, threads=16)
    want_rows = rows_reference(case)
    np.testing.assert_array_equal(rows_out, want_rows)
    np.testing.assert_array_equal(got, port_plain(case))
    chunks = -(-case["nv"] // case["qd"])
    for row, slots in ZERO_SLOT_CASES[name][1].items():
        for k in slots:  # the slot's pair (a ratio, A or B) is zero
            pair = 0 if k == chunks - 1 else (k + 1 if k < chunks else k)
            assert not rows_out[row, 2 * pair:2 * pair + 2].any()
        if min(slots) < chunks:
            assert not rows_out[row, :2].any()  # the row's total
    assert stats["chains"] == case["n"]


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


def test_kernel_constants_match_wrapper():
    # the wrapper's sizes are the kernels' (csrc/stage23.cu)
    assert CU["MAX_TID"] == stage23.MAX_TID
    assert CU["SCAN_TILE"] == stage23.SCAN_TILE
    assert 32 * CU["ROUNDS_LARGE"] == stage23.MAX_INVERSES
    assert (CU["STATUS_HEAD"], CU["STATUS_WORDS"]) == (
        stage23.STATUS_HEAD, stage23.STATUS_WORDS)
    assert CU["NUM_PARAMS"] == len(stage23.row_params(
        4, 3, 4, 3, 3, None, 3, 3))
    assert [stage23.scan_launches(n) for n in (1, 256, 257, 1 << 17)] == \
        [1] * 4


def test_scan_status_zeroed_once_and_shared():
    # one zeroed buffer a stream, grown when a call needs more tiles;
    # epochs only grow
    key_stream = 12345
    a = stage23.scan_status("cpu", key_stream, 100)
    assert a.numel() == stage23.STATUS_HEAD + stage23.STATUS_WORDS
    assert not a.any()
    tile = stage23.SCAN_TILE
    assert stage23.scan_status("cpu", key_stream, tile) is a
    b = stage23.scan_status("cpu", key_stream, 3 * tile + 1)
    assert b.numel() >= stage23.STATUS_HEAD + 4 * stage23.STATUS_WORDS
    assert not b.any() and b is not a
    assert stage23.scan_status("cpu", key_stream + 1, 100) is not b
    e = stage23.new_epoch()
    assert stage23.new_epoch() > e > 0


def test_other_devices_raise():
    # a tensor on another device type is refused, never computed plainly
    case = make_case("no_lookup")
    wit = gl.from_u64(case["wit"]).to("meta")
    with pytest.raises(RuntimeError):
        stage23.stage23(wit, gl.from_u64(case["setup"]).to("meta"),
                        gl.from_u64(case["x_vals"]).to("meta"),
                        stage23.NonResidues.make(case["non_res"], "cpu"),
                        case["beta"], case["gamma"], case["qd"])
