"""Abstract interval domain for graph-level NaN-safety analysis.

An :class:`Interval` over-approximates the set of values a traced graph node
can take, given the physical axis bounds of :class:`repro_torch.spec.ParamSpace`
as the initial abstraction.  Two refinements beyond textbook interval
arithmetic make it precise enough to verify the repo's masking idioms:

* **Open endpoints.**  ``lo_open`` / ``hi_open`` record whether the endpoint
  value itself is *attainable*.  An unbounded axis like ``pSortMB`` has the
  interval ``(0, +inf)`` with both ends open: it can be arbitrarily large but
  never *equals* ``inf``.  Actual infinities enter a program only through
  a literal ``inf`` (the masking idiom) or a division whose denominator
  attains 0 — exactly the events the nan-hazard checker cares about.  This
  distinction is what keeps the checker from drowning in false ``inf - inf``
  reports: ``x - y`` over two merely-unbounded values is finite, while
  ``where(ok, cost, inf) - where(ok2, cost2, inf)`` really can be NaN.

* **Attainability-aware hazard predicates.**  :meth:`attains_zero`,
  :meth:`attains_pinf` and :meth:`attains_ninf` ask whether the *endpoint
  itself* is reachable — ``(0, 1]`` does not attain zero, ``[0, 1]`` does.
  A double-``where`` guard works precisely because the guarded
  denominator's interval is refined to an open-at-zero interval inside the
  taken branch; revert the guard and the closed zero bound reappears.

Interval arithmetic here is *conservative*: when an exact open/closed
endpoint computation would be intricate (e.g. products of mixed-sign
intervals), the result widens toward closed (= attained) endpoints, which
can only create false positives, never false negatives, in the hazard
checks.  NaN possibility is tracked separately via ``maybe_nan``.

Carried over unchanged in its arithmetic from the reference package's
``repro/analysis/interval.py``; ``tests/test_torch_analysis.py`` pins the
two to each other.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

__all__ = ["Interval", "TOP", "FINITE_TOP", "NONNEG", "UNIT", "BOOL"]

_INF = math.inf


@dataclass(frozen=True)
class Interval:
    """A set of reals ``{x : lo (<|<=) x (<|<=) hi}``, possibly plus NaN."""

    lo: float
    hi: float
    lo_open: bool = False
    hi_open: bool = False
    maybe_nan: bool = False

    # ---------------- constructors ----------------

    @staticmethod
    def point(v: float) -> "Interval":
        if math.isnan(v):
            # a literal NaN: empty numeric range, definitely NaN
            return Interval(_INF, -_INF, True, True, maybe_nan=True)
        return Interval(v, v)

    @staticmethod
    def bounded(lo, hi, lo_open=False, hi_open=False) -> "Interval":
        lo = -_INF if lo is None else float(lo)
        hi = _INF if hi is None else float(hi)
        # an infinite endpoint coming from "no declared bound" is a limit,
        # never an attained value
        if lo == -_INF:
            lo_open = True
        if hi == _INF:
            hi_open = True
        return Interval(lo, hi, lo_open, hi_open)

    # ---------------- hazard predicates ----------------

    def attains(self, v: float) -> bool:
        """Is the exact value ``v`` a member of the set?"""
        if self.lo < v < self.hi:
            return True
        if v == self.lo and not self.lo_open:
            return True
        if v == self.hi and not self.hi_open:
            return True
        return False

    @property
    def attains_zero(self) -> bool:
        return self.attains(0.0)

    @property
    def attains_pinf(self) -> bool:
        return self.hi == _INF and not self.hi_open

    @property
    def attains_ninf(self) -> bool:
        return self.lo == -_INF and not self.lo_open

    @property
    def attains_inf(self) -> bool:
        return self.attains_pinf or self.attains_ninf

    @property
    def is_nonneg(self) -> bool:
        return self.lo > 0 or (self.lo == 0 and True)

    def contains_negative(self) -> bool:
        return self.lo < 0

    def __str__(self) -> str:  # compact, for finding messages
        l, r = "([" [not self.lo_open], ")]" [not self.hi_open]
        nan = "+nan" if self.maybe_nan else ""
        return f"{l}{self.lo:g}, {self.hi:g}{r}{nan}"

    # ---------------- lattice ----------------

    def hull(self, other: "Interval") -> "Interval":
        """Smallest interval containing both (set union over-approximation)."""
        if self.lo < other.lo:
            lo, lo_open = self.lo, self.lo_open
        elif other.lo < self.lo:
            lo, lo_open = other.lo, other.lo_open
        else:
            lo, lo_open = self.lo, self.lo_open and other.lo_open
        if self.hi > other.hi:
            hi, hi_open = self.hi, self.hi_open
        elif other.hi > self.hi:
            hi, hi_open = other.hi, other.hi_open
        else:
            hi, hi_open = self.hi, self.hi_open and other.hi_open
        return Interval(lo, hi, lo_open, hi_open,
                        self.maybe_nan or other.maybe_nan)

    def intersect(self, other: "Interval") -> "Interval":
        """Set intersection (used by branch refinement).  An empty
        intersection collapses to the refining interval — conservative but
        keeps downstream math defined."""
        if other.lo > self.lo or (other.lo == self.lo and other.lo_open):
            lo, lo_open = other.lo, other.lo_open
        else:
            lo, lo_open = self.lo, self.lo_open
        if other.hi < self.hi or (other.hi == self.hi and other.hi_open):
            hi, hi_open = other.hi, other.hi_open
        else:
            hi, hi_open = self.hi, self.hi_open
        if lo > hi:
            return other
        return Interval(lo, hi, lo_open, hi_open, self.maybe_nan)

    def widen_against(self, newer: "Interval") -> "Interval":
        """Fixpoint widening: any endpoint that moved goes to its infinity."""
        lo, lo_open = self.lo, self.lo_open
        hi, hi_open = self.hi, self.hi_open
        if newer.lo < lo:
            lo, lo_open = -_INF, True
        if newer.hi > hi:
            hi, hi_open = _INF, True
        # endpoint attainability can also grow (closed beats open)
        if newer.lo == lo and not newer.lo_open:
            lo_open = False
        if newer.hi == hi and not newer.hi_open:
            hi_open = False
        return Interval(lo, hi, lo_open, hi_open,
                        self.maybe_nan or newer.maybe_nan)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Interval):
            return NotImplemented
        return (self.lo == other.lo and self.hi == other.hi
                and self.lo_open == other.lo_open
                and self.hi_open == other.hi_open
                and self.maybe_nan == other.maybe_nan)

    # ---------------- arithmetic ----------------

    def neg(self) -> "Interval":
        return Interval(-self.hi, -self.lo, self.hi_open, self.lo_open,
                        self.maybe_nan)

    def add(self, o: "Interval") -> "Interval":
        nan = (self.maybe_nan or o.maybe_nan
               or (self.attains_pinf and o.attains_ninf)
               or (self.attains_ninf and o.attains_pinf))
        lo = self.lo + o.lo
        if math.isnan(lo):          # -inf + inf endpoint pairing
            lo = -_INF
        hi = self.hi + o.hi
        if math.isnan(hi):
            hi = _INF
        return Interval(lo, hi,
                        self.lo_open or o.lo_open,
                        self.hi_open or o.hi_open, nan)

    def sub(self, o: "Interval") -> "Interval":
        return self.add(o.neg())

    def _sign_parts(self):
        """Split into sign-homogeneous subintervals ('+': ⊆ [0, inf],
        '-': ⊆ [-inf, 0]); 0 straddled in the interior is attained."""
        if self.lo >= 0:
            return [("+", self)]
        if self.hi <= 0:
            return [("-", self)]
        return [
            ("-", Interval(self.lo, 0.0, self.lo_open, False)),
            ("+", Interval(0.0, self.hi, False, self.hi_open)),
        ]

    @staticmethod
    def _mul_nonneg(a: "Interval", b: "Interval") -> "Interval":
        """Product of two intervals ⊆ [0, +inf].  Matched-endpoint products
        avoid the spurious 0 x inf corner of the naive all-pairs rule."""
        lo = a.lo * b.lo
        if math.isnan(lo):              # [inf, inf] x an interval attaining 0
            lo, lo_open = 0.0, True
        elif lo == 0.0:
            # 0 attained iff whichever operand supplies the zero attains it
            if a.lo == 0.0 and b.lo == 0.0:
                lo_open = a.lo_open and b.lo_open
            elif a.lo == 0.0:
                lo_open = a.lo_open
            else:
                lo_open = b.lo_open
        else:
            lo_open = a.lo_open or b.lo_open
        if a.hi == _INF or b.hi == _INF:
            attained = (a.attains_pinf and b.hi > 0.0) or \
                       (b.attains_pinf and a.hi > 0.0)
            hi, hi_open = _INF, not attained
        else:
            hi = a.hi * b.hi
            hi_open = a.hi_open or b.hi_open
        return Interval(lo, hi, lo_open, hi_open)

    def mul(self, o: "Interval") -> "Interval":
        nan = (self.maybe_nan or o.maybe_nan
               or (self.attains_inf and o.attains_zero)
               or (self.attains_zero and o.attains_inf))
        res: "Interval | None" = None
        for sa, ia in self._sign_parts():
            for sb, ib in o._sign_parts():
                pa = ia if sa == "+" else ia.neg()
                pb = ib if sb == "+" else ib.neg()
                p = self._mul_nonneg(pa, pb)
                if sa != sb:
                    p = p.neg()
                res = p if res is None else res.hull(p)
        assert res is not None
        return Interval(res.lo, res.hi, res.lo_open, res.hi_open, nan)

    def div(self, o: "Interval") -> "Interval":
        nan = (self.maybe_nan or o.maybe_nan
               or (self.attains_zero and o.attains_zero)
               or (self.attains_inf and o.attains_inf))
        if o.attains_zero:
            # an actual division by zero produces an actual infinity
            return Interval(-_INF, _INF, False, False, nan)
        if o.attains(0.0) is False and (o.lo < 0 < o.hi):
            # denominator straddles 0 only through open endpoints — results
            # are unbounded both ways but inf itself is never attained
            return Interval(-_INF, _INF, True, True, nan)
        inv = o._reciprocal()
        return self.mul(replace(inv, maybe_nan=False)) if not nan else \
            replace(self.mul(inv), maybe_nan=True)

    def _reciprocal(self) -> "Interval":
        # assumes 0 is not attained; endpoints map to reciprocals, an open
        # zero endpoint maps to an open infinity
        def rec(v, is_open):
            if v == 0.0:
                return _INF, True
            if v == _INF or v == -_INF:
                return 0.0, True
            return 1.0 / v, is_open

        a, ao = rec(self.lo, self.lo_open)
        b, bo = rec(self.hi, self.hi_open)
        # sign conventions: 1/(lo,hi) for same-sign intervals swaps ends
        if self.lo > 0 or (self.lo == 0):
            return Interval(b, a, bo, ao, self.maybe_nan)
        if self.hi < 0 or (self.hi == 0):
            return Interval(b, a, bo, ao, self.maybe_nan)
        return Interval(-_INF, _INF, True, True, self.maybe_nan)

    def min_(self, o: "Interval") -> "Interval":
        if self.lo < o.lo:
            lo, lo_open = self.lo, self.lo_open
        elif o.lo < self.lo:
            lo, lo_open = o.lo, o.lo_open
        else:
            lo, lo_open = self.lo, self.lo_open and o.lo_open
        if self.hi < o.hi:
            hi, hi_open = self.hi, self.hi_open
        elif o.hi < self.hi:
            hi, hi_open = o.hi, o.hi_open
        else:
            hi, hi_open = self.hi, self.hi_open or o.hi_open
        return Interval(lo, hi, lo_open, hi_open,
                        self.maybe_nan or o.maybe_nan)

    def max_(self, o: "Interval") -> "Interval":
        return self.neg().min_(o.neg()).neg()

    def abs_(self) -> "Interval":
        if self.lo >= 0:
            return self
        if self.hi <= 0:
            return self.neg()
        neg, pos = self.neg(), self
        hi = max(neg.hi, pos.hi)
        hi_open = all(i.hi_open for i in (neg, pos) if i.hi == hi)
        return Interval(0.0, hi, False, hi_open, self.maybe_nan)

    def monotone(self, fn, *, nan_below: float | None = None,
                 nan_at: float | None = None) -> "Interval":
        """Apply a monotonically increasing scalar function to both ends.

        ``nan_below``: arguments < that value produce NaN (e.g. ``log`` and
        negatives); ``nan_at``: that attained argument produces ±inf
        (``log`` at 0).  Endpoint results of ``±inf`` inherit openness from
        whether the dangerous argument is attained.
        """
        nan = self.maybe_nan or (nan_below is not None and self.lo < nan_below)

        def app(v, is_open):
            try:
                r = fn(v)
            except (ValueError, OverflowError):
                return (-_INF, True) if v < 0 or v < (nan_below or 0) \
                    else (_INF, True)
            if math.isnan(r):
                return -_INF, True
            return r, is_open

        lo, lo_open = app(self.lo, self.lo_open)
        hi, hi_open = app(self.hi, self.hi_open)
        if nan_at is not None and self.attains(nan_at):
            # e.g. log at an attained 0: the -inf endpoint is attained
            lo, lo_open = min(lo, -_INF), False
        return Interval(min(lo, hi), max(lo, hi),
                        lo_open if lo <= hi else hi_open,
                        hi_open if lo <= hi else lo_open, nan)

    def round_like(self, mode: str) -> "Interval":
        """floor / ceil / round / trunc: endpoints round, set stays bounded
        by the rounded endpoints; finite endpoints become attainable."""
        f = {"floor": math.floor, "ceil": math.ceil,
             "round": round, "trunc": math.trunc}[mode]

        def app(v, is_open):
            if v in (-_INF, _INF):
                return v, is_open
            return float(f(v)), False
        lo, lo_open = app(self.lo, self.lo_open)
        hi, hi_open = app(self.hi, self.hi_open)
        return Interval(lo, hi, lo_open, hi_open, self.maybe_nan)

    def scale_by_count(self, n: int) -> "Interval":
        """Over-approximation of an ``n``-term reduction (sum/cumsum): the
        hull of ``k * x`` for ``k`` in 0..n over this per-element interval."""
        acc = Interval.point(0.0)
        per = self.mul(Interval(0.0, float(max(n, 0))))
        return acc.hull(per)


#: any finite value, sign unknown — the default for unknown primitives
FINITE_TOP = Interval(-_INF, _INF, True, True)
#: any value including attained infinities
TOP = Interval(-_INF, _INF, False, False)
#: physical nonnegative quantity, unbounded but finite
NONNEG = Interval(0.0, _INF, False, True)
#: a fraction in [0, 1]
UNIT = Interval(0.0, 1.0)
#: a boolean (comparisons, logical ops)
BOOL = Interval(0.0, 1.0)
