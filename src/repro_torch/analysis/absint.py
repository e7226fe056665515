"""Interval abstract interpretation over aten graphs traced by ``make_fx``.

:func:`trace` turns a function of tensors into a ``torch.fx.GraphModule`` of
aten ops (``torch.fx.experimental.proxy_tensor.make_fx``, real tensors), with
the source line of the user code behind each op in ``node.meta``.
:func:`analyze_graph` walks that graph, propagating an
:class:`~repro_torch.analysis.interval.Interval` per node, and records
**events** at hazardous ops (division, remainder, log, sqrt, pow, the
subtraction of infinities, ...) for the checkers to turn into findings.
The mechanics are the reference's (``repro/analysis/absint.py``), on aten
ops in place of jaxpr primitives:

* **Provenance tokens.**  Each abstract value carries the node it is a
  pass-through of.  Shape- and dtype-only ops (``_to_copy``, ``expand``,
  ``view``, ``clone``, ``lift_fresh_copy``, ...) keep it, so a comparison on
  ``x`` can refine a ``where`` case that is ``x`` after a cast or a
  broadcast.

* **Predicate refinement at** ``aten.where.self`` (the reference's
  ``select_n``).  ``where(pred, a, b)`` with ``pred = gt(x, c)`` (or
  ge/lt/le/eq/ne/isfinite) narrows the interval of ``a`` when ``a`` *is*
  ``x`` by provenance, and of ``b`` with the negated predicate.  This is how
  a double-``where`` guard proves its denominator non-zero, and why
  reverting the guard (dividing *before* the ``where``) re-fires the hazard.

* **Straight-through roundings are exempt in grad mode.**  The
  ``repro_torch::ste_*`` custom operators
  (:mod:`repro_torch.core.hadoop.merge_math`) own their gradient; only a bare
  ``floor``/``ceil``/``round``/``trunc``, a float-to-integer cast or a
  ``detach`` on a differentiated path records a grad-blocker event.

* **Loops reach a fixpoint.**  A host loop over a round (the wave
  rollout's scheduling rounds) is traced as three straight-line graphs,
  :class:`LoopGraphs`: the state before the first round, one round, and the
  outputs of the final state.  :func:`analyze_loop` walks the round over
  the state's intervals, joining each round's result into the state (hull)
  and, from round :data:`MAX_LOOP_ITERS` on, widening every endpoint that
  still moves to its infinity, until the state stops changing: the
  reference's ``prim_while`` / ``prim_scan``.  A trace of one round alone
  would see only the first round's values.

An op without a transfer function produces
:data:`~repro_torch.analysis.interval.FINITE_TOP` and is recorded as a
coverage gap rather than silently trusted.
"""

from __future__ import annotations

import math
import operator
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from .interval import BOOL, FINITE_TOP, TOP, Interval

__all__ = ["AbsValue", "Event", "Analysis", "LoopGraphs", "analyze_graph",
           "analyze_loop", "trace", "leaves", "LOCATION_KEY", "MAX_LOOP_ITERS"]

_INF = math.inf

#: rounds of a loop joined by hull before widening (the reference's
#: ``max_while_iters``)
MAX_LOOP_ITERS = 3

#: ``node.meta`` key holding ``"file:line in function"`` of the user code
#: that issued the op
LOCATION_KEY = "repro_location"

#: namespace of the straight-through rounding operators
_STE_NS = "repro_torch"

_REPO_ROOT = Path(__file__).resolve().parents[3]
_HERE = os.path.abspath(__file__)


@dataclass(frozen=True)
class AbsValue:
    """An interval plus the provenance token of the value it passes through.

    ``origin`` is the graph node where the value was introduced; it survives
    shape- and dtype-only ops, so guard predicates can be matched to the
    value they actually constrain.
    """

    ival: Interval
    origin: Any = None


@dataclass
class Event:
    """One potentially hazardous op occurrence."""

    kind: str                 # "div0", "inf_minus_inf", "rounding", ...
    op: str                   # aten op name, e.g. "aten.div.Tensor"
    location: str             # "path/file.py:123 in fn" or "<unknown>"
    detail: str               # human-readable interval story
    chain: tuple[str, ...] = ()


@dataclass
class Analysis:
    """Result of one :func:`analyze_graph` run."""

    events: list[Event] = field(default_factory=list)
    unknown_ops: set[str] = field(default_factory=set)
    out_vals: list[AbsValue] = field(default_factory=list)
    #: a loop's state intervals at the fixpoint (:func:`analyze_loop`)
    loop_state: list[Interval] = field(default_factory=list)


# ---------------------------------------------------------------------------
# tracing with source locations
# ---------------------------------------------------------------------------


def _user_location() -> str:
    """``file:line in function`` of the innermost frame outside torch and
    outside this module."""
    import torch

    torch_dir = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if not (path.startswith(torch_dir) or path == _HERE
                or path.startswith("<") or "contextlib" in path):
            try:
                shown = os.path.relpath(path, _REPO_ROOT)
            except ValueError:
                shown = path
            if shown.startswith(".."):
                shown = path
            return f"{shown}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return "<unknown>"


def trace(fn: Callable, *args):
    """``make_fx(fn)(*args)`` with real tensors: a GraphModule of aten ops.

    A dispatch mode above the tracer notes the user frame of every op it
    sees; the notes are matched to the graph's call nodes in order (an op
    the tracer decomposes takes the location of the op it came from) and
    stored in ``node.meta[LOCATION_KEY]``.
    """
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._python_dispatch import TorchDispatchMode

    notes: list[tuple[Any, str]] = []

    class _NoteLocations(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            notes.append((func, _user_location()))
            return func(*args, **(kwargs or {}))

    def noted(*a):
        with _NoteLocations():
            return fn(*a)

    gm = make_fx(noted)(*args)
    i = 0
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        for j in range(i, min(i + 8, len(notes))):
            if notes[j][0] == node.target:
                node.meta[LOCATION_KEY] = notes[j][1]
                i = j + 1
                break
        else:
            if i < len(notes):
                node.meta[LOCATION_KEY] = notes[i][1]
    return gm


# ---------------------------------------------------------------------------
# predicate refinement
# ---------------------------------------------------------------------------
# comparison -> (refinement of x where TRUE, where FALSE), as functions of
# the interval of the value x is compared with


def _refine_gt(c: Interval):
    return Interval(c.lo, _INF, True, True), Interval(-_INF, c.hi, True, False)


def _refine_ge(c: Interval):
    return Interval(c.lo, _INF, False, True), Interval(-_INF, c.hi, True, True)


def _refine_lt(c: Interval):
    return Interval(-_INF, c.hi, True, True), Interval(c.lo, _INF, False, True)


def _refine_le(c: Interval):
    return Interval(-_INF, c.hi, True, False), Interval(c.lo, _INF, True, True)


def _refine_eq(c: Interval):
    return Interval(c.lo, c.hi), TOP


def _refine_ne(c: Interval):
    return TOP, Interval(c.lo, c.hi)


def _refine_isfinite(_c: Interval):
    return Interval(-_INF, _INF, True, True), TOP


_CMP_REFINERS: dict[str, Callable] = {
    "gt": _refine_gt, "ge": _refine_ge, "lt": _refine_lt, "le": _refine_le,
    "eq": _refine_eq, "ne": _refine_ne,
}


@dataclass
class _Guard:
    """A predicate's constraint: which origin, true- and false-intervals."""

    origin: Any
    true_ival: Interval
    false_ival: Interval


# ops whose one tensor operand passes through with its value unchanged
_PASS_THROUGH = {
    "expand", "view", "clone", "lift_fresh_copy", "alias", "reshape",
    "_unsafe_view", "squeeze", "unsqueeze", "contiguous",
}

_BOOL_OPS = {
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_not", "isnan", "isinf",
}

_ROUNDING = {"floor", "ceil", "round", "trunc"}


class _Interp:
    def __init__(self, gm, analysis: Analysis, *, grad_mode: bool):
        self.gm = gm
        self.an = analysis
        self.grad_mode = grad_mode
        self.env: dict = {}
        # predicate node -> _Guard
        self.guards: dict = {}
        # nodes whose value derives only from comparisons and constants
        # (validity flags): detach or an integer cast of them is benign
        self.bool_derived: set = set()
        # abs node -> the origin of its operand (a guard on |x| bounds x)
        self.abs_of: dict = {}

    # ---- values ----

    @staticmethod
    def _is_node(a) -> bool:
        return hasattr(a, "op") and hasattr(a, "target")

    def read(self, a) -> AbsValue:
        if self._is_node(a):
            return self.env[a]
        if isinstance(a, (bool, int, float)):
            return AbsValue(Interval.point(float(a)))
        return AbsValue(FINITE_TOP)

    def is_bool_derived(self, a) -> bool:
        if not self._is_node(a):
            return True
        av = self.env.get(a)
        if av is None:
            return False
        if av.origin in self.bool_derived or a in self.bool_derived:
            return True
        iv = av.ival
        return iv.lo == iv.hi and not iv.maybe_nan

    @staticmethod
    def _tensor_ival(t) -> Interval:
        import torch

        if t.numel() == 0:
            return FINITE_TOP
        if t.dtype == torch.bool:
            return BOOL
        v = t.detach().to("cpu", torch.float64)
        if bool(torch.isnan(v).any()):
            finite = v[~torch.isnan(v)]
            if finite.numel() == 0:
                return Interval.point(float("nan"))
            return Interval(float(finite.min()), float(finite.max()),
                            maybe_nan=True)
        return Interval(float(v.min()), float(v.max()))

    def record(self, kind: str, node, detail: str):
        self.an.events.append(Event(
            kind=kind, op=str(node.target),
            location=node.meta.get(LOCATION_KEY, "<unknown>"),
            detail=detail))

    # ---- the walk ----

    def run(self, in_intervals: list[Interval]) -> list[AbsValue]:
        ins = iter(in_intervals)
        out: list[AbsValue] = []
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.env[node] = AbsValue(next(ins, FINITE_TOP), node)
            elif node.op == "get_attr":
                t = getattr(self.gm, node.target)
                self.env[node] = AbsValue(self._tensor_ival(t), node)
            elif node.op == "call_function":
                self.env[node] = self.call(node)
            elif node.op == "output":
                out = [self.read(a) for a in leaves(node.args[0])]
            else:
                self.env[node] = AbsValue(FINITE_TOP, node)
        return out

    def call(self, node) -> AbsValue:
        if node.target is operator.getitem:     # one output of a multi-output op
            src, i = node.args
            return self.env[src][i]
        full = str(node.target)         # e.g. "aten.where.self"
        parts = full.split(".")
        ns, name = parts[0], parts[1] if len(parts) > 1 else parts[0]
        if ns == _STE_NS and name.startswith("ste_"):
            # the straight-through operators own their gradient: no event
            a = self.read(node.args[0])
            return AbsValue(a.ival.round_like(name[4:]), node)
        if ns != "aten":
            self.an.unknown_ops.add(full)
            return AbsValue(FINITE_TOP, node)
        handler = getattr(self, f"op_{name}", None)
        if handler is not None:
            return handler(node)
        if name in _PASS_THROUGH:
            return self.read(node.args[0])
        if name in _BOOL_OPS:
            if all(self.is_bool_derived(a) for a in node.args
                   if self._is_node(a)):
                self.bool_derived.add(node)
            return AbsValue(BOOL, node)
        if name in _ROUNDING:
            return self._rounding(node, name)
        if name in _CMP_REFINERS:
            return self._comparison(node, name)
        self.an.unknown_ops.add(full)
        return AbsValue(FINITE_TOP, node)

    # ---- arithmetic ----

    def _two(self, node) -> tuple[AbsValue, AbsValue]:
        return self.read(node.args[0]), self.read(node.args[1])

    def _taint(self, node, operands):
        if all(self.is_bool_derived(a) for a in operands):
            self.bool_derived.add(node)

    def _alpha(self, node, b: AbsValue) -> AbsValue:
        alpha = node.kwargs.get("alpha")
        if alpha is None or alpha == 1:
            return b
        return AbsValue(b.ival.mul(Interval.point(float(alpha))))

    def _add(self, node, a: Interval, b: Interval, what: str) -> AbsValue:
        if (a.attains_pinf and b.attains_ninf) or \
                (a.attains_ninf and b.attains_pinf):
            self.record("inf_minus_inf", node,
                        f"{what} of {a} and {b} can be inf - inf")
        return AbsValue(a.add(b), node)

    def op_add(self, node):
        a, b = self._two(node)
        b = self._alpha(node, b)
        self._taint(node, node.args[:2])
        return self._add(node, a.ival, b.ival, "add")

    def op_sub(self, node):
        a, b = self._two(node)
        b = self._alpha(node, b)
        return self._add(node, a.ival, b.ival.neg(), "sub")

    def op_rsub(self, node):
        a, b = self._two(node)          # other - alpha * self
        a = self._alpha(node, a)
        return self._add(node, b.ival, a.ival.neg(), "rsub")

    def _and_guards(self, node) -> None:
        """``mul`` of two flags (``isfinite`` decomposes to ``(x == x) *
        (|x| != inf)``): where both constrain the same value, their
        conjunction holds where both do."""
        g = [self.guards.get(a) for a in node.args[:2] if self._is_node(a)]
        if len(g) == 2 and None not in g and g[0].origin is g[1].origin:
            self.guards[node] = _Guard(g[0].origin,
                                       g[0].true_ival.intersect(g[1].true_ival),
                                       g[0].false_ival.hull(g[1].false_ival))

    def op_mul(self, node):
        self._and_guards(node)
        a, b = self._two(node)
        if (a.ival.attains_inf and b.ival.attains_zero) or \
                (a.ival.attains_zero and b.ival.attains_inf):
            self.record("zero_times_inf", node,
                        f"mul of {a.ival} and {b.ival} can be 0 * inf")
        self._taint(node, node.args[:2])
        return AbsValue(a.ival.mul(b.ival), node)

    def _div(self, node, a: Interval, b: Interval) -> Interval:
        if b.attains_zero:
            self.record("div0", node,
                        f"denominator {b} attains 0 (numerator {a})")
        if a.attains_inf and b.attains_inf:
            self.record("inf_over_inf", node, f"inf/inf possible: {a} / {b}")
        return a.div(b)

    def op_div(self, node):
        a, b = self._two(node)
        out = self._div(node, a.ival, b.ival)
        mode = node.kwargs.get("rounding_mode")
        if mode is not None:
            if self.grad_mode:
                self.record("rounding", node,
                            f"division with rounding_mode={mode!r} has zero "
                            "derivative")
            out = out.round_like("floor" if mode == "floor" else "trunc")
        return AbsValue(out, node)

    def op_reciprocal(self, node):      # a Python number over a tensor
        a = self.read(node.args[0])
        return AbsValue(self._div(node, Interval.point(1.0), a.ival), node)

    def op_remainder(self, node):
        a, b = self._two(node)
        if b.ival.attains_zero:
            self.record("div0", node, f"mod denominator {b.ival} attains 0")
        hi = b.ival.abs_().hi
        return AbsValue(Interval(-hi, hi, True, True,
                                 a.ival.maybe_nan or b.ival.maybe_nan), node)

    def op_maximum(self, node):
        a, b = self._two(node)
        self._taint(node, node.args[:2])
        return AbsValue(a.ival.max_(b.ival), node)

    def op_minimum(self, node):
        a, b = self._two(node)
        self._taint(node, node.args[:2])
        return AbsValue(a.ival.min_(b.ival), node)

    def op_neg(self, node):
        return AbsValue(self.read(node.args[0]).ival.neg(), node)

    def op_abs(self, node):
        a = self.read(node.args[0])
        if a.origin is not None:
            self.abs_of[node] = a.origin
        return AbsValue(a.ival.abs_(), node)

    def op_pow(self, node):
        base, ex = self._two(node)
        b, e = base.ival, ex.ival
        integral = e.lo == e.hi and float(e.lo).is_integer()
        if b.contains_negative() and not integral:
            self.record("pow_domain", node,
                        f"negative base {b} to non-integer power {e}")
        if b.attains_zero and e.lo < 0:
            self.record("div0", node, f"{b} to the power {e} divides by 0")
        if integral and 0 < e.lo <= 5:
            out = b
            for _ in range(int(e.lo) - 1):
                out = out.mul(b)
            return AbsValue(out, node)
        return AbsValue(FINITE_TOP, node)

    def op_exp(self, node):
        return AbsValue(self.read(node.args[0]).ival.monotone(math.exp), node)

    def op_expm1(self, node):
        return AbsValue(self.read(node.args[0]).ival.monotone(math.expm1), node)

    def op_sigmoid(self, node):
        a = self.read(node.args[0]).ival
        return AbsValue(Interval(0.0, 1.0, True, True, a.maybe_nan), node)

    def op_clamp(self, node):
        a = self.read(node.args[0]).ival
        lo, hi = (list(node.args[1:3]) + [None, None])[:2]
        lo = node.kwargs.get("min", lo)
        hi = node.kwargs.get("max", hi)
        if lo is not None:
            a = a.max_(Interval.point(float(lo)))
        if hi is not None:
            a = a.min_(Interval.point(float(hi)))
        return AbsValue(a, node)

    def op_sum(self, node):
        # an n-term reduction: the hull of k * x for k in 0..n
        src, out = node.args[0], node.meta.get("val")
        n_in = src.meta["val"].numel() if self._is_node(src) else 1
        n = n_in // max(out.numel(), 1) if out is not None else n_in
        return AbsValue(self.read(src).ival.scale_by_count(n), node)

    # ---- reductions, scans, permutations and constants ----

    def _dim_size(self, node, dim) -> int:
        shape = node.args[0].meta["val"].shape if self._is_node(node.args[0]) else ()
        return int(shape[dim]) if len(shape) else 1

    def _elements(self, node) -> AbsValue:
        """An op whose values are some of its input's elements (a new
        origin: positions move, so a guard on the input does not apply)."""
        return AbsValue(self.read(node.args[0]).ival, node)

    op_amin = op_flip = op_select = _elements

    def _values_indices(self, node, dim) -> tuple[AbsValue, AbsValue]:
        n = self._dim_size(node, dim)
        return (AbsValue(self.read(node.args[0]).ival, node),
                AbsValue(Interval(0.0, float(max(n - 1, 0))), node))

    def op_max(self, node):
        if len(node.args) < 2:                  # a full reduction
            return self._elements(node)
        return self._values_indices(node, node.args[1])

    op_min = op_max

    def op_sort(self, node):
        dim = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim", -1)
        return self._values_indices(node, dim)

    def op_cumsum(self, node):
        # the k-th partial sum is a sum of k terms: the hull of k * x, k <= n
        n = self._dim_size(node, node.args[1])
        return AbsValue(self.read(node.args[0]).ival.scale_by_count(n), node)

    def op_mean(self, node):
        a = self.read(node.args[0]).ival
        nan = a.maybe_nan or (a.attains_pinf and a.attains_ninf)
        return AbsValue(Interval(a.lo, a.hi, a.lo_open, a.hi_open, nan), node)

    def op_all(self, node):
        if all(self.is_bool_derived(a) for a in node.args if self._is_node(a)):
            self.bool_derived.add(node)
        return AbsValue(BOOL, node)

    def _fill(self, node, value) -> AbsValue:
        self.bool_derived.add(node)
        return AbsValue(Interval.point(float(value)), node)

    def op_full(self, node):
        return self._fill(node, node.args[1])

    def op_full_like(self, node):
        return self._fill(node, node.args[1])

    def op_zeros(self, node):
        return self._fill(node, 0.0)

    op_zeros_like = op_zeros

    def op_arange(self, node):
        a = [float(v) for v in node.args]
        start, end = (0.0, a[0]) if len(a) == 1 else (a[0], a[1])
        step = a[2] if len(a) > 2 else 1.0
        n = max(math.ceil((end - start) / step), 1)
        last = start + (n - 1) * step
        self.bool_derived.add(node)
        return AbsValue(Interval(min(start, last), max(start, last)), node)

    # ---- domain-restricted unary ops ----

    def _domain_unary(self, node, kind, lo_bad, fn, nan_at=None):
        a = self.read(node.args[0]).ival
        if a.lo < lo_bad or (nan_at is not None and a.attains(nan_at)):
            self.record(kind, node, f"argument {a} reaches the singular domain")
        return AbsValue(a.monotone(fn, nan_below=lo_bad, nan_at=nan_at), node)

    def op_log(self, node):
        return self._domain_unary(node, "log_domain", 0.0, math.log, 0.0)

    def op_log2(self, node):
        return self._domain_unary(node, "log_domain", 0.0, math.log2, 0.0)

    def op_sqrt(self, node):
        a = self.read(node.args[0]).ival
        if a.lo < 0:
            self.record("sqrt_domain", node, f"argument {a} can be negative")
        return AbsValue(a.monotone(math.sqrt, nan_below=0.0), node)

    def op_rsqrt(self, node):
        a = self.read(node.args[0]).ival
        if a.lo < 0:
            self.record("sqrt_domain", node,
                        f"rsqrt argument {a} can be negative")
        if a.attains_zero:
            self.record("div0", node, f"rsqrt argument {a} attains 0")
        return AbsValue(Interval(0.0, _INF, True, not a.attains_zero,
                                 a.maybe_nan or a.lo < 0), node)

    # ---- gradient blockers ----

    def _rounding(self, node, mode):
        if self.grad_mode:
            self.record("rounding", node,
                        f"{mode} has zero derivative: gradients through this "
                        "path silently vanish")
        return AbsValue(self.read(node.args[0]).ival.round_like(mode), node)

    def op_detach(self, node):
        src = self.read(node.args[0])
        if self.grad_mode and not self.is_bool_derived(node.args[0]):
            self.record("stop_gradient", node,
                        "detach of a non-boolean value inside a "
                        "differentiated path zeroes its gradient")
        return src

    def op__to_copy(self, node):
        import torch

        arg = node.args[0]
        src = self.read(arg)
        new = node.kwargs.get("dtype")
        old = getattr(arg.meta.get("val"), "dtype", None) \
            if self._is_node(arg) else None
        derived = self.is_bool_derived(arg)
        if derived:
            self.bool_derived.add(node)
        if self.grad_mode and new is not None and old is not None and \
                old.is_floating_point and not new.is_floating_point and \
                not new.is_complex and not derived:
            self.record("int_cast", node,
                        f"{old} -> {new} cast inside a differentiated path")
        if old == torch.bool:
            return AbsValue(BOOL, src.origin)
        return src

    def op_scalar_tensor(self, node):
        return AbsValue(self.read(node.args[0]).ival, node)

    # ---- comparisons register guards ----

    def _comparison(self, node, name):
        a, b = self._two(node)
        if a.origin in self.abs_of and name == "ne" and b.ival.lo == b.ival.hi == _INF:
            # |x| != inf: x is finite (the other half of a decomposed isfinite)
            self.guards[node] = _Guard(self.abs_of[a.origin],
                                       Interval(-_INF, _INF, True, True), TOP)
        elif a.origin is not None:
            t, f = _CMP_REFINERS[name](b.ival)
            self.guards[node] = _Guard(a.origin, t, f)
        self.bool_derived.add(node)
        return AbsValue(BOOL, node)

    def op_isfinite(self, node):
        a = self.read(node.args[0])
        if a.origin is not None:
            t, f = _refine_isfinite(a.ival)
            self.guards[node] = _Guard(a.origin, t, f)
        self.bool_derived.add(node)
        return AbsValue(BOOL, node)

    # ---- selection with guard refinement ----

    def op_where(self, node):
        pred, on_true, on_false = node.args[:3]
        guard = None
        if self._is_node(pred):
            guard = self.guards.get(pred)
            if guard is None:
                guard = self.guards.get(self.env[pred].origin)
        out = None
        for arg, take_true in ((on_true, True), (on_false, False)):
            case = self.read(arg)
            ival = case.ival
            if guard is not None and case.origin is not None \
                    and case.origin is guard.origin:
                ival = ival.intersect(guard.true_ival if take_true
                                      else guard.false_ival)
            out = ival if out is None else out.hull(ival)
        if self.is_bool_derived(on_true) and self.is_bool_derived(on_false):
            self.bool_derived.add(node)
        return AbsValue(out, node)


def leaves(tree) -> list:
    """The leaves of a nest of lists, tuples and dicts, in order."""
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    return [tree]


@dataclass
class LoopGraphs:
    """A host loop traced as three straight-line graphs (from :func:`trace`)
    over the loop's inputs ``xs`` and its state ``st``, a flat list of
    tensors in a fixed order:

    * ``init(*xs) -> st``, the state before the first round;
    * ``body(*xs, *st) -> st``, one round;
    * ``finish(*xs, *st) -> outputs``, the outputs of the final state.
    """

    init: Any
    body: Any
    finish: Any

    @property
    def n_nodes(self) -> int:
        return sum(len(g.graph.nodes) for g in (self.init, self.body, self.finish))


def analyze_loop(loop: LoopGraphs, in_intervals: list[Interval], *,
                 grad_mode: bool = False,
                 max_iters: int = MAX_LOOP_ITERS) -> Analysis:
    """Walk a :class:`LoopGraphs` with one interval per loop input.

    The round is walked over the state's intervals until they stop
    changing: the first ``max_iters`` rounds join by hull, later ones widen
    every endpoint that still moves to its infinity (so the walk ends).
    Events are those of ``init``, of the round at the fixpoint (its state
    covers every round's, and the transfer functions are monotone, so it
    records whatever an earlier round would) and of ``finish``.
    """
    analysis = Analysis()

    def walk(gm, ivals, chain):
        sink = Analysis()
        outs = _Interp(gm, sink, grad_mode=grad_mode).run(ivals)
        analysis.unknown_ops |= sink.unknown_ops
        for e in sink.events:
            e.chain = (chain,) + e.chain
        return [o.ival for o in outs], sink.events

    xs = list(in_intervals)
    carry, events = walk(loop.init, xs, "loop:init")
    analysis.events.extend(events)
    it = 0
    while True:
        new, events = walk(loop.body, xs + carry, "loop:round")
        if len(new) != len(carry):
            raise ValueError(f"the loop round returns {len(new)} state "
                             f"values for a state of {len(carry)}")
        joined = [old.widen_against(n) if it >= max_iters else old.hull(n)
                  for old, n in zip(carry, new)]
        if joined == carry:
            break
        carry = joined
        it += 1
    analysis.events.extend(events)
    analysis.loop_state = carry
    outs, events = walk(loop.finish, xs + carry, "loop:finish")
    analysis.events.extend(events)
    analysis.out_vals = [AbsValue(iv) for iv in outs]
    return analysis


def analyze_graph(gm, in_intervals: list[Interval], *,
                  grad_mode: bool = False) -> Analysis:
    """Walk ``gm`` (from :func:`trace`) with one interval per placeholder.

    ``grad_mode`` additionally records rounding / detach / integer-cast
    events (the grad-blocker hazard set): use it on graphs whose inputs are
    differentiated.
    """
    analysis = Analysis()
    interp = _Interp(gm, analysis, grad_mode=grad_mode)
    analysis.out_vals = interp.run(list(in_intervals))
    return analysis
