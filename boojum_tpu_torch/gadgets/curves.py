# Copied from boojum_tpu/gadgets/curves.py.
"""Short-Weierstrass curve points over a non-native field.

Reference behavior: src/gadgets/curves/sw_projective/mod.rs (projective point
ops over NonNativeField). This build uses affine coordinates with witness
slopes (each constrained by its defining equation, with a witness-inverse
proof that denominators are nonzero), covering add / double /
on-curve checks; scalar multiplication composes them.
"""

from __future__ import annotations

from ..cs.cs import ConstraintSystem
from .non_native import NonNativeField, NonNativeParams


class SWAffinePoint:
    """(x, y) on y² = x³ + a·x + b over the foreign field."""

    def __init__(self, x: NonNativeField, y: NonNativeField, a: int, b: int):
        self.x = x
        self.y = y
        self.a = a
        self.b = b

    @classmethod
    def allocate_checked(cls, cs: ConstraintSystem, params: NonNativeParams,
                         x_val: int, y_val: int, a: int, b: int,
                         table_ids=None) -> "SWAffinePoint":
        x = NonNativeField.allocate_checked(cs, params, x_val, table_ids)
        y = NonNativeField.allocate_checked(cs, params, y_val, table_ids)
        pt = cls(x, y, a, b)
        pt.enforce_on_curve()
        return pt

    def _cs(self):
        return self.x.cs

    def _params(self):
        return self.x.params

    def _const(self, v: int) -> NonNativeField:
        return NonNativeField.constant(self._cs(), self._params(), v,
                                       self.x.table_ids)

    def enforce_on_curve(self):
        """y² == x³ + a·x + b."""
        cs = self._cs()
        y2 = self.y.mul(self.y)
        x2 = self.x.mul(self.x)
        x3 = x2.mul(self.x)
        rhs = x3
        if self.a:
            rhs = rhs.add(self._const(self.a).mul(self.x))
        rhs = rhs.add(self._const(self.b))
        _enforce_nn_equal(y2, rhs)

    def _nonzero_witness_inverse(self, d: NonNativeField) -> NonNativeField:
        """Allocate 1/d and enforce d·inv == 1 (proves d != 0)."""
        cs = self._cs()
        params = self._params()
        d_val = d.get_witness() if cs.resolver else 1
        inv_val = pow(d_val % params.modulus, params.modulus - 2,
                      params.modulus) if d_val % params.modulus else 0
        inv = NonNativeField.allocate_checked(cs, params, inv_val,
                                              self.x.table_ids)
        prod = d.mul(inv)
        _enforce_nn_equal(prod, self._const(1))
        return inv

    def add_unequal(self, other: "SWAffinePoint") -> "SWAffinePoint":
        """P + Q for P != ±Q (x1 != x2, proven by witness inverse)."""
        cs = self._cs()
        params = self._params()
        dx = other.x.add(_nn_neg(self.x))
        self._nonzero_witness_inverse(dx)
        dy = other.y.add(_nn_neg(self.y))
        # slope s: s·dx == dy
        M = params.modulus
        if cs.resolver:
            s_val = (dy.get_witness() *
                     pow(dx.get_witness() % M, M - 2, M)) % M
        else:
            s_val = 0
        s = NonNativeField.allocate_checked(cs, params, s_val, self.x.table_ids)
        _enforce_nn_equal(s.mul(dx), dy)
        # x3 = s² − x1 − x2 ; y3 = s·(x1 − x3) − y1
        x3 = s.mul(s).add(_nn_neg(self.x)).add(_nn_neg(other.x))
        y3 = s.mul(self.x.add(_nn_neg(x3))).add(_nn_neg(self.y))
        return SWAffinePoint(x3, y3, self.a, self.b)

    def double(self) -> "SWAffinePoint":
        cs = self._cs()
        params = self._params()
        M = params.modulus
        two_y = self.y.add(self.y)
        self._nonzero_witness_inverse(two_y)
        # s·(2y) == 3x² + a
        x2 = self.x.mul(self.x)
        num = x2.add(x2).add(x2)
        if self.a:
            num = num.add(self._const(self.a))
        if cs.resolver:
            s_val = (num.get_witness() *
                     pow(two_y.get_witness() % M, M - 2, M)) % M
        else:
            s_val = 0
        s = NonNativeField.allocate_checked(cs, params, s_val, self.x.table_ids)
        _enforce_nn_equal(s.mul(two_y), num)
        x3 = s.mul(s).add(_nn_neg(self.x)).add(_nn_neg(self.x))
        y3 = s.mul(self.x.add(_nn_neg(x3))).add(_nn_neg(self.y))
        return SWAffinePoint(x3, y3, self.a, self.b)


def _nn_neg(a: NonNativeField) -> NonNativeField:
    """M − a (as a fresh reduced element)."""
    cs = a.cs
    params = a.params
    val = (-a.get_witness()) % params.modulus if cs.resolver else 0
    neg = NonNativeField.allocate_checked(cs, params, val, a.table_ids)
    s = a.add(neg)
    _enforce_nn_equal(s, NonNativeField.constant(cs, params, 0, a.table_ids))
    return neg


def _enforce_nn_equal(a: NonNativeField, b: NonNativeField):
    """Limbwise equality of two REDUCED representatives.

    Both sides here come out of mul/add (always fully reduced by the q·M + r
    witness identity with r range-limited), so limb equality is sound."""
    from .num import CircuitOps
    ops = CircuitOps(a.cs)
    for la, lb in zip(a.limbs, b.limbs):
        ops.enforce_equal(la, lb)


# -- host-side affine arithmetic (exact ints; for constants/corrections) ----


def host_ec_add(p1, p2, a: int, M: int):
    """Affine add on y² = x³ + a·x + b over F_M; None = infinity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % M == 0:
            return None
        s = (3 * x1 * x1 + a) * pow(2 * y1, M - 2, M) % M
    else:
        s = (y2 - y1) * pow(x2 - x1, M - 2, M) % M
    x3 = (s * s - x1 - x2) % M
    return (x3, (s * (x1 - x3) - y1) % M)


def host_ec_mul(pt, k: int, a: int, M: int):
    acc = None
    while k:
        if k & 1:
            acc = host_ec_add(acc, pt, a, M)
        pt = host_ec_add(pt, pt, a, M)
        k >>= 1
    return acc


class SWAffinePointExt(SWAffinePoint):
    """SWAffinePoint + scalar multiplication via blinded double-and-add.

    Reference behavior: sw_projective scalar ladder. Affine model: the
    accumulator starts at a caller-supplied constant blinding point B (so no
    intermediate hits infinity for honest witnesses), runs MSB-first
    double-and-add with limbwise point selects, and subtracts 2^n·B (host
    precomputed constant) at the end. add_unequal's witness-inverse makes
    any x-collision unprovable rather than unsound."""

    def select_point(self, flag_var, other: "SWAffinePoint") -> "SWAffinePointExt":
        x = NonNativeField.select(flag_var, self.x, other.x)
        y = NonNativeField.select(flag_var, self.y, other.y)
        return SWAffinePointExt(x, y, self.a, self.b)

    def mul_by_scalar_bits(self, bits: list, blind_xy: tuple) -> "SWAffinePointExt":
        """bits: scalar bit variables, LSB first (each boolean-constrained by
        the caller); blind_xy: host (x, y) of the blinding point B."""
        cs = self._cs()
        params = self._params()
        M = params.modulus
        n = len(bits)
        acc = SWAffinePointExt(
            NonNativeField.constant(cs, params, blind_xy[0], self.x.table_ids),
            NonNativeField.constant(cs, params, blind_xy[1], self.x.table_ids),
            self.a, self.b)
        base = SWAffinePointExt(self.x, self.y, self.a, self.b)
        for bit in reversed(bits):
            acc = SWAffinePointExt(*_pt(acc.double()), self.a, self.b)
            added = SWAffinePointExt(*_pt(acc.add_unequal(base)), self.a, self.b)
            acc = added.select_point(bit, acc)
        corr = host_ec_mul(blind_xy, 1 << n, self.a, M)
        corr_neg = (corr[0], (-corr[1]) % M)
        corr_pt = SWAffinePointExt(
            NonNativeField.constant(cs, params, corr_neg[0], self.x.table_ids),
            NonNativeField.constant(cs, params, corr_neg[1], self.x.table_ids),
            self.a, self.b)
        return SWAffinePointExt(*_pt(acc.add_unequal(corr_pt)), self.a, self.b)


def _pt(p: SWAffinePoint):
    return (p.x, p.y)


class SWProjectivePoint:
    """Short-Weierstrass point in projective coordinates (X : Y : Z) with a
    COMPLETE addition law — the identity (0 : 1 : 0), P + (−P), 0·G and
    doubling collisions are all handled structurally, with no witness-inverse
    escape hatches.

    Reference behavior: src/gadgets/curves/sw_projective/mod.rs:1-519
    (zeroable projective coordinates, convert_to_affine_or_default). The
    formulas are Renes-Costello-Batina 2015 Algorithm 1 (complete addition
    for prime-order SW curves, general ``a``, using b3 = 3b) — every input
    pair takes the same constraint path, so adversarial witnesses cannot
    steer the circuit onto an unconstrained branch."""

    def __init__(self, x: NonNativeField, y: NonNativeField,
                 z: NonNativeField, a: int, b: int):
        self.x, self.y, self.z = x, y, z
        self.a, self.b = a, b

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_affine(cls, pt: SWAffinePoint) -> "SWProjectivePoint":
        one = NonNativeField.constant(pt.x.cs, pt.x.params, 1, pt.x.table_ids)
        return cls(pt.x, pt.y, one, pt.a, pt.b)

    @classmethod
    def zero(cls, cs: ConstraintSystem, params: NonNativeParams, a: int,
             b: int, table_ids=None) -> "SWProjectivePoint":
        return cls(NonNativeField.constant(cs, params, 0, table_ids),
                   NonNativeField.constant(cs, params, 1, table_ids),
                   NonNativeField.constant(cs, params, 0, table_ids), a, b)

    def _const(self, v: int) -> NonNativeField:
        return NonNativeField.constant(self.x.cs, self.x.params,
                                       v % self.x.params.modulus,
                                       self.x.table_ids)

    # -- group law -----------------------------------------------------------

    def add(self, other: "SWProjectivePoint") -> "SWProjectivePoint":
        """Complete addition (RCB15 Algorithm 1); works for EVERY input pair
        including P == Q, P == -Q and either operand being the identity."""
        a = self.a
        b3 = (3 * self.b) % self.x.params.modulus
        X1, Y1, Z1 = self.x, self.y, self.z
        X2, Y2, Z2 = other.x, other.y, other.z

        t0 = X1.mul(X2)
        t1 = Y1.mul(Y2)
        t2 = Z1.mul(Z2)
        t3 = X1.add(Y1).mul(X2.add(Y2)).sub(t0).sub(t1)  # X1Y2 + X2Y1
        t4 = X1.add(Z1).mul(X2.add(Z2)).sub(t0).sub(t2)  # X1Z2 + X2Z1
        t5 = Y1.add(Z1).mul(Y2.add(Z2)).sub(t1).sub(t2)  # Y1Z2 + Y2Z1

        def amul(v):
            return v.mul(self._const(a)) if a else \
                NonNativeField.constant(v.cs, v.params, 0, v.table_ids)

        z3 = amul(t4).add(t2.mul(self._const(b3)))
        x3 = t1.sub(z3)
        z3 = t1.add(z3)
        y3 = x3.mul(z3)
        t1n = t0.double().add(t0)                 # 3·X1X2
        t2a = amul(t2)
        t4b = t4.mul(self._const(b3))
        t1n = t1n.add(t2a)
        t2d = t0.sub(t2a)
        t2d = amul(t2d)
        t4b = t4b.add(t2d)
        t0n = t1n.mul(t4b)
        Y3 = y3.add(t0n)
        t0n = t5.mul(t4b)
        X3 = t3.mul(x3).sub(t0n)
        Z3 = t5.mul(z3).add(t3.mul(t1n))
        return SWProjectivePoint(X3, Y3, Z3, self.a, self.b)

    def double(self) -> "SWProjectivePoint":
        return self.add(self)

    def negate(self) -> "SWProjectivePoint":
        return SWProjectivePoint(self.x, self.y.neg(), self.z,
                                 self.a, self.b)

    def select(self, flag_var, other: "SWProjectivePoint"):
        """flag ? self : other (limbwise)."""
        return SWProjectivePoint(
            NonNativeField.select(flag_var, self.x, other.x),
            NonNativeField.select(flag_var, self.y, other.y),
            NonNativeField.select(flag_var, self.z, other.z),
            self.a, self.b)

    # -- scalar multiplication ------------------------------------------------

    def mul_by_scalar_bits(self, bits: list) -> "SWProjectivePoint":
        """Double-and-add, LSB-first bit variables. The accumulator starts
        at the identity and every step uses the complete law, so zero
        scalars, order-multiple scalars and doubling collisions are all fine
        (reference sw_projective ladder capabilities)."""
        cs = self.x.cs
        acc = SWProjectivePoint.zero(cs, self.x.params, self.a, self.b,
                                     self.x.table_ids)
        base = self
        for bit in reversed(bits):
            acc = acc.double()
            added = acc.add(base)
            acc = added.select(bit, acc)
        return acc

    # -- conversions -----------------------------------------------------------

    def is_zero(self):
        """Boolean variable: Z == 0 (the identity)."""
        return self.z.is_zero()

    def convert_to_affine_or_default(self, default_xy: tuple):
        """(X/Z, Y/Z) for finite points, the host constant ``default_xy``
        for the identity (reference convert_to_affine_or_default). Returns
        (SWAffinePoint, is_infinity boolean var)."""
        flag = self.z.is_zero()
        zinv = self.z.allocate_inverse_or_zero()
        x_aff = self.x.mul(zinv)
        y_aff = self.y.mul(zinv)
        dx = self._const(default_xy[0] % self.x.params.modulus)
        dy = self._const(default_xy[1] % self.x.params.modulus)
        x_out = NonNativeField.select(flag, dx, x_aff)
        y_out = NonNativeField.select(flag, dy, y_aff)
        return SWAffinePoint(x_out, y_out, self.a, self.b), flag
