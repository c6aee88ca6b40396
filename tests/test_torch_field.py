"""The port's Goldilocks and GL2 tensor ops against the JAX package's field
ops and the host numpy twin (utils/npgl), on random vectors and on the edge
cases of tests/test_field.py. Every comparison is exact equality of
canonical u64 values."""

import numpy as np
import pytest

from boojum_tpu.field import extension as ref_ext
from boojum_tpu.field import goldilocks as ref_gl
from boojum_tpu.utils import npgl as ref_npgl
from boojum_tpu_torch.field import extension as ext
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.utils import npgl

P = gl.ORDER
EDGE = [0, 1, 2, 7, P - 1, P - 2, 0xFFFFFFFF, 0x100000000, P - 0xFFFFFFFF,
        (1 << 63) % P, gl.RADIX_2_SUBGROUP_GENERATOR]


def _vectors(seed, n=2048):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, n, dtype=np.uint64)
    b = rng.integers(0, P, n, dtype=np.uint64)
    # every edge value against every edge value
    ea = np.array([x for x in EDGE for _ in EDGE], np.uint64)
    eb = np.array([y for _ in EDGE for y in EDGE], np.uint64)
    return np.concatenate([a, ea]), np.concatenate([b, eb])


def _t(x):
    return gl.from_u64(x)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_reference(op):
    a, b = _vectors(1)
    got = gl.to_u64(getattr(gl, op)(_t(a), _t(b)))
    want = ref_gl.to_u64(getattr(ref_gl, op)(ref_gl.from_u64(a),
                                             ref_gl.from_u64(b)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, getattr(ref_npgl, op)(a, b))


def test_unary_ops_and_scalars():
    a, _ = _vectors(2)
    ta = _t(a)
    assert np.array_equal(gl.to_u64(gl.neg(ta)), ref_npgl.neg(a))
    assert np.array_equal(gl.to_u64(gl.double(ta)), ref_npgl.add(a, a))
    assert np.array_equal(gl.to_u64(gl.square(ta)), ref_npgl.mul(a, a))
    for k in (7, 1 << 40, P - 1, 0x185629DCDA58878C):
        assert np.array_equal(gl.to_u64(gl.mul(ta, k)),
                              ref_npgl.mul_scalar(a, k))
        assert np.array_equal(gl.to_u64(gl.add(ta, k)),
                              ref_npgl.add(a, np.uint64(k)))
        assert np.array_equal(gl.to_u64(gl.sub(ta, k)),
                              ref_npgl.sub(a, np.uint64(k)))


def test_pow_inverse_and_canonicalize():
    a, _ = _vectors(3, n=256)
    ta = _t(a)
    want_pow = ref_gl.to_u64(ref_gl.pow_const(ref_gl.from_u64(a), 12345))
    assert np.array_equal(gl.to_u64(gl.pow_const(ta, 12345)), want_pow)
    inv = gl.to_u64(gl.inverse(ta))
    assert np.array_equal(inv, ref_npgl.inv(a))  # 0 -> 0 in both
    assert np.array_equal(gl.to_u64(gl.batch_inverse(ta)), inv)
    # every u64 pattern at or above p reduces once
    lazy = np.array([P, P + 1, (1 << 64) - 1, P + 0xFFFFFFFE], np.uint64)
    assert np.array_equal(gl.to_u64(gl.canonicalize(_t(lazy))),
                          lazy - np.uint64(P))


def test_scalar_helpers_and_constants():
    for log_n in (0, 1, 5, 16, 32):
        assert gl.domain_generator(log_n) == ref_gl.domain_generator(log_n)
    assert (gl.ORDER, gl.EPSILON, gl.MULTIPLICATIVE_GENERATOR,
            gl.TWO_ADICITY) == (ref_gl.ORDER, ref_gl.EPSILON,
                                ref_gl.MULTIPLICATIVE_GENERATOR,
                                ref_gl.TWO_ADICITY)
    x, y = P - 5, 0xDEADBEEF12345
    assert gl.s_mul(x, y) == ref_gl.s_mul(x, y)
    assert gl.s_inv(x) == ref_gl.s_inv(x)
    assert gl.i64(P - 1) == -(1 << 32)
    s = gl.sum_mod(_t(np.array([P - 1, P - 1, 5], np.uint64)))
    assert int(gl.to_u64(s[None])[0]) == (2 * (P - 1) + 5) % P


def _ext_pair(seed, n=512):
    a0, a1 = _vectors(seed, n)
    return a0, a1


def test_ext_ops_match_reference():
    a0, a1 = _ext_pair(4)
    b0, b1 = _ext_pair(5)
    ta, tb = (_t(a0), _t(a1)), (_t(b0), _t(b1))
    ra = ref_ext.GL2(ref_gl.from_u64(a0), ref_gl.from_u64(a1))
    rb = ref_ext.GL2(ref_gl.from_u64(b0), ref_gl.from_u64(b1))
    for op in ("add", "sub", "mul"):
        got = getattr(ext, op)(ta, tb)
        want = getattr(ref_ext, op)(ra, rb)
        assert np.array_equal(gl.to_u64(got[0]), ref_gl.to_u64(want.c0)), op
        assert np.array_equal(gl.to_u64(got[1]), ref_gl.to_u64(want.c1)), op
    # host twin of the same ext mul
    h = ref_npgl.ext_mul((a0, a1), (b0, b1))
    got = ext.mul(ta, tb)
    assert np.array_equal(gl.to_u64(got[0]), h[0])
    assert np.array_equal(gl.to_u64(got[1]), h[1])


def test_ext_inverse_scale_and_scans():
    a0, a1 = _ext_pair(6, n=128)
    a0[a0 == 0] = 1
    ta = (_t(a0), _t(a1))
    inv = ext.inverse(ta)
    one = ext.mul(ta, inv)
    assert (gl.to_u64(one[0]) == 1).all() and (gl.to_u64(one[1]) == 0).all()
    c = (P - 3, 0x1234567890)
    got = ext.scale(ta, c)
    for i in (0, 5, 77):
        want = ref_ext.s2_mul((int(a0[i]), int(a1[i])), c)
        assert (int(gl.to_u64(got[0])[i]), int(gl.to_u64(got[1])[i])) == want
    pre = ext.exclusive_prefix_mul(ta)
    want = ref_npgl.ext_exclusive_prefix_mul((a0, a1))
    assert np.array_equal(gl.to_u64(pre[0]), want[0])
    assert np.array_equal(gl.to_u64(pre[1]), want[1])
    pw = ext.powers(c, 100)
    want = ref_npgl.ext_powers(c, 100)
    assert np.array_equal(gl.to_u64(pw[0]), want[0])
    assert np.array_equal(gl.to_u64(pw[1]), want[1])


def test_npgl_copy_matches_reference():
    a, b = _vectors(7, n=3000)  # above the reference's native-path sizes
    assert np.array_equal(npgl.mul(a, b), ref_npgl.mul(a, b))
    assert np.array_equal(npgl.batch_inv(a[:200]), ref_npgl.batch_inv(a[:200]))
    assert np.array_equal(npgl.powers(7, 1000), ref_npgl.powers(7, 1000))
