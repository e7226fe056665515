"""Declarative searchable-axis descriptions: :class:`Axis` + :class:`ParamSpace`.

The paper's Tables 1-3 define *what* a configuration is; this module makes
that structure machine-readable.  A :class:`ParamSpace` is the single source
of truth for

* **names + types** — which keys are sweepable, whether a key is an integer
  count, a boolean flag or a float, and which paper table it came from;
* **coercion** — how a float override (everything is a float tensor on
  device) routes back onto a typed dataclass field
  (:meth:`ParamSpace.apply`);
* **grid construction** — :meth:`ParamSpace.grid` validates a candidate
  space (unknown keys, out-of-bounds values, non-0/1 booleans) *before* a
  10^6-row product is streamed through an evaluator;
* **validity** — per-axis bounds plus named cross-axis :class:`Predicate`
  constraints produce a row mask with *inspectable* per-constraint reasons
  (:meth:`ParamSpace.validity_mask`).  (The Hadoop job model's own
  validity — the §2.3 merge-math domain — depends on model outputs, not raw
  knobs, and is surfaced by :class:`repro_torch.spec.report.CostReport`
  instead.)

Each axis also carries a continuous relaxation (:meth:`Axis.relax` /
:meth:`Axis.project`): the unconstrained space that calibration
(:mod:`repro_torch.calib`) and gradient search
(:func:`repro_torch.search.gradient_descent_ev`) descend in.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Iterator, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.hadoop.merge_math import ste_round
from repro_torch.core.hadoop.params import CostFactors, HadoopParams, ProfileStats

__all__ = ["Axis", "Predicate", "ParamSpace", "hadoop_space"]

_KINDS = ("float", "int", "bool")


@dataclass(frozen=True)
class Axis:
    """One searchable configuration axis (a row of a paper parameter table).

    ``kind`` drives coercion back onto typed fields: ``int``/``bool`` axes
    round (the device-side sweep is always float).  ``lower``/``upper`` are
    *physical* bounds used by :meth:`ParamSpace.grid` validation and the
    validity mask — not search ranges.
    """

    name: str
    kind: str = "float"
    lower: float | None = None
    upper: float | None = None
    lower_open: bool = False        # True: lower bound is exclusive
    unit: str = ""                  # "bytes", "fraction", "s/byte", ...
    table: str = ""                 # paper provenance ("Table 1", ...)
    group: str = ""                 # owning dataclass ("params"/"stats"/"costs")
    doc: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"axis {self.name!r}: kind must be one of {_KINDS}")

    def coerce(self, value) -> int | bool | float:
        """One float override value -> the typed field value."""
        if self.kind == "int":
            return int(round(float(value)))
        if self.kind == "bool":
            return bool(round(float(value)))
        return float(value)

    def coerce_array(self, values: np.ndarray) -> np.ndarray:
        """Column form of :meth:`coerce` (ints/bools round to int64)."""
        v = np.asarray(values)
        if self.kind in ("int", "bool"):
            return np.round(v.astype(np.float64)).astype(np.int64)
        return v.astype(np.float64)

    def bounds_mask(self, values: np.ndarray) -> np.ndarray | None:
        """Per-row in-bounds mask (``None`` when the axis is unbounded).

        Boolean axes carry no bounds mask: their meaning is defined by
        coercion (``> 0.5`` rounds to True), not by a range.
        """
        if self.kind == "bool" or (self.lower is None and self.upper is None):
            return None
        v = self.coerce_array(values)
        ok = np.ones(v.shape, dtype=bool)
        if self.lower is not None:
            ok &= (v > self.lower) if self.lower_open else (v >= self.lower)
        if self.upper is not None:
            ok &= v <= self.upper
        return ok

    # ---------------- continuous relaxation ----------------

    def _relax_bounds(self) -> tuple[float | None, float | None]:
        # Boolean axes carry no declared bounds; their relaxation lives on
        # (0, 1) and rounds straight-through back to {0, 1}.
        if self.kind == "bool":
            return 0.0, 1.0
        lo = None if self.lower is None else float(self.lower)
        hi = None if self.upper is None else float(self.upper)
        return lo, hi

    def relax(self, value) -> np.ndarray:
        """Physical value -> unconstrained real (host-side, numpy).

        Inverse of :meth:`project` up to rounding: two-sided bounds use the
        logit, one-sided bounds the log offset (well-conditioned for cost
        factors spanning 1e-9..1e-7), unbounded axes the identity.  Values
        at a closed bound are nudged into the interior so the inverse stays
        finite.
        """
        v = np.asarray(value, dtype=np.float64)
        lo, hi = self._relax_bounds()
        if lo is not None and hi is not None:
            frac = np.clip((v - lo) / (hi - lo), 1e-9, 1.0 - 1e-9)
            return np.log(frac) - np.log1p(-frac)
        if lo is not None:
            return np.log(np.maximum(v - lo, 1e-30))
        if hi is not None:
            return np.log(np.maximum(hi - v, 1e-30))
        return v

    def project(self, u: torch.Tensor) -> torch.Tensor:
        """Unconstrained real -> differentiable in-domain value (a tensor).

        The forward map of the relaxation: sigmoid for two-sided bounds,
        ``bound +/- exp(u)`` for one-sided, identity when unbounded.
        ``int``/``bool`` axes additionally round straight-through
        (:func:`repro_torch.core.hadoop.merge_math.ste_round`): the forward
        value is an exact integer while the gradient treats the axis as
        continuous.
        """
        lo, hi = self._relax_bounds()
        if lo is not None and hi is not None:
            v = lo + (hi - lo) * torch.sigmoid(u)
        elif lo is not None:
            v = lo + torch.exp(u)
        elif hi is not None:
            v = hi - torch.exp(u)
        else:
            v = u
        if self.kind in ("int", "bool"):
            v = ste_round(v)
        return v

    def check_values(self, values: Sequence[float]) -> None:
        """Raise ``ValueError`` on candidate values outside the axis domain."""
        v = np.asarray(list(values), dtype=np.float64)
        if self.kind == "bool":
            if not np.isin(np.round(v), (0.0, 1.0)).all():
                raise ValueError(
                    f"axis {self.name!r} is boolean; candidates must round "
                    f"to 0 or 1, got {values!r}"
                )
            return
        mask = self.bounds_mask(v)
        if mask is not None and not mask.all():
            bad = v[~mask]
            lo = f"({self.lower}" if self.lower_open else f"[{self.lower}"
            raise ValueError(
                f"axis {self.name!r}: candidate values {bad.tolist()} outside "
                f"domain {lo}, {self.upper}]"
            )


@dataclass(frozen=True)
class Predicate:
    """A named cross-axis validity constraint.

    ``fn`` receives *coerced* columns (ints/bools already rounded to int64)
    for every axis present and returns a boolean row mask.  The name is what
    shows up in validity-reason reports and fallback log lines.
    """

    name: str
    fn: Callable[[Mapping[str, np.ndarray]], np.ndarray]
    doc: str = ""


class ParamSpace:
    """An ordered, typed description of a model's searchable axes."""

    def __init__(self, axes: Sequence[Axis], predicates: Sequence[Predicate] = ()):
        self._axes: dict[str, Axis] = {}
        for ax in axes:
            if ax.name in self._axes:
                raise ValueError(f"duplicate axis: {ax.name!r}")
            self._axes[ax.name] = ax
        self.predicates = tuple(predicates)

    # ---------------- mapping-style introspection ----------------

    @property
    def axes(self) -> tuple[Axis, ...]:
        return tuple(self._axes.values())

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self._axes)

    def __contains__(self, name: str) -> bool:
        return name in self._axes

    def __getitem__(self, name: str) -> Axis:
        try:
            return self._axes[name]
        except KeyError:
            raise KeyError(
                f"unknown config key: {name!r} (known axes: {list(self._axes)})"
            ) from None

    def __iter__(self) -> Iterator[Axis]:
        return iter(self._axes.values())

    def __len__(self) -> int:
        return len(self._axes)

    # ---------------- coercion / routing ----------------

    def coerce(self, name: str, value) -> int | bool | float:
        return self[name].coerce(value)

    def coerce_assignment(self, assignment: Mapping[str, float]) -> dict:
        """Typed copy of a flat float assignment (raises on unknown keys)."""
        return {k: self[k].coerce(v) for k, v in assignment.items()}

    def apply(self, assignment: Mapping[str, float], *objs):
        """Route a flat assignment onto dataclass instances with coercion.

        For each object, fields named in ``assignment`` are replaced with
        the axis-coerced value; keys matching no object's fields are
        ignored (the historical ``apply_assignment`` contract).  Keys that
        are fields of an object use that axis's kind when the axis exists,
        otherwise plain float.
        """
        out = []
        for obj in objs:
            kw = {}
            for k, v in assignment.items():
                if k in obj.__dataclass_fields__:
                    kw[k] = self[k].coerce(v) if k in self else float(v)
            out.append(dataclasses.replace(obj, **kw) if kw else obj)
        return tuple(out)

    # ---------------- grid construction ----------------

    def grid(
        self, space: Mapping[str, Sequence[float]] | None = None, /, **axes
    ) -> dict[str, np.ndarray]:
        """Validated candidate space: ``{axis name: float64 candidates}``.

        The single entry point for building search spaces: unknown axis
        names, empty axes, out-of-bounds values and non-0/1 boolean
        candidates all fail *here*, before any evaluator streams the
        product.  The returned dict feeds ``repro_torch.search`` strategies and
        ``WhatIfService.grid`` unchanged.
        """
        merged: dict[str, Sequence[float]] = dict(space or {})
        merged.update(axes)
        if not merged:
            raise ValueError("grid() needs at least one axis")
        out: dict[str, np.ndarray] = {}
        for name, values in merged.items():
            ax = self[name]
            vals = np.asarray(list(np.atleast_1d(values)), dtype=np.float64)
            if vals.size == 0:
                raise ValueError(f"axis {name!r} has no candidate values")
            ax.check_values(vals)
            out[name] = vals
        return out

    # ---------------- validity ----------------

    def validity_mask(
        self, cols: Mapping[str, np.ndarray]
    ) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        """Row-validity of a column batch, with per-constraint masks.

        Returns ``(overall, reasons)`` where ``reasons`` maps constraint
        name (``"<axis> bounds"`` or a :class:`Predicate` name) to its own
        boolean mask — so a ``valid == 0`` row can say *which* constraint
        failed, not just that one did.
        """
        cols = {k: np.asarray(v) for k, v in cols.items()}
        for k in cols:
            self[k]                      # raise on unknown keys
        shape = np.broadcast_shapes(*(v.shape for v in cols.values())) \
            if cols else ()
        overall = np.ones(shape, dtype=bool)
        reasons: dict[str, np.ndarray] = {}
        for k, v in cols.items():
            m = self[k].bounds_mask(v)
            if m is not None:
                reasons[f"{k} bounds"] = np.broadcast_to(m, shape)
                overall = overall & m
        coerced = {k: self[k].coerce_array(v) for k, v in cols.items()}
        for pred in self.predicates:
            m = np.broadcast_to(np.asarray(pred.fn(coerced), dtype=bool), shape)
            reasons[pred.name] = m
            overall = overall & m
        return overall, reasons


# --------------------------------------------------------------------------
# the Hadoop space (paper Tables 1-3)
# --------------------------------------------------------------------------

# name -> (lower, upper, lower_open): physical domains, not search ranges.
_HADOOP_BOUNDS: dict[str, tuple[float | None, float | None, bool]] = {
    "pNumNodes": (1, None, False),
    "pTaskMem": (0, None, True),
    "pMaxMapsPerNode": (1, None, False),
    "pMaxRedPerNode": (1, None, False),
    "pNumMappers": (1, None, False),
    "pSortMB": (0, None, True),
    "pSpillPerc": (0, 1, True),
    "pSortRecPerc": (0, 1, False),
    "pSortFactor": (2, None, False),
    "pNumSpillsForComb": (0, None, False),
    "pNumReducers": (0, None, False),
    "pInMemMergeThr": (1, None, False),
    "pShuffleInBufPerc": (0, 1, False),
    "pShuffleMergePerc": (0, 1, False),
    "pReducerInBufPerc": (0, 1, False),
    "pReduceSlowstart": (0, 1, False),
    "pSplitSize": (0, None, True),
    "sInputPairWidth": (0, None, True),
    # Strictly positive: Eq. 10 (outPairWidth = outMapSize / outMapPairs)
    # divides by it; a profile observing literally zero map-output pairs has
    # no defined pair width, so 0 is outside the physical domain.
    "sMapPairsSel": (0, None, True),
    "sInputCompressRatio": (0, None, True),
    "sIntermCompressRatio": (0, None, True),
    "sOutCompressRatio": (0, None, True),
}

_HADOOP_UNITS: dict[str, str] = {
    "pTaskMem": "bytes",
    "pSortMB": "MB",
    "pSplitSize": "bytes",
    "pSpillPerc": "fraction",
    "pSortRecPerc": "fraction",
    "pShuffleInBufPerc": "fraction",
    "pShuffleMergePerc": "fraction",
    "pReducerInBufPerc": "fraction",
    "pReduceSlowstart": "fraction",
    "sInputPairWidth": "bytes/pair",
    "cHdfsReadCost": "s/byte",
    "cHdfsWriteCost": "s/byte",
    "cLocalIOCost": "s/byte",
    "cNetworkCost": "s/byte",
    "cMapCPUCost": "s/pair",
    "cReduceCPUCost": "s/pair",
    "cCombineCPUCost": "s/pair",
    "cPartitionCPUCost": "s/pair",
    "cSerdeCPUCost": "s/pair",
    "cSortCPUCost": "s/pair",
    "cMergeCPUCost": "s/pair",
    "cInUncomprCPUCost": "s/byte",
    "cIntermUncomprCPUCost": "s/byte",
    "cIntermComprCPUCost": "s/byte",
    "cOutComprCPUCost": "s/byte",
}


def _kind_of(field: dataclasses.Field) -> str:
    t = field.type if isinstance(field.type, str) else getattr(
        field.type, "__name__", "float")
    return {"int": "int", "bool": "bool"}.get(t, "float")


@functools.lru_cache(maxsize=None)
def hadoop_space() -> ParamSpace:
    """The paper's full configuration space, one axis per Table-1/2/3 field.

    Axis order matches :data:`repro_torch.core.hadoop.model.CONFIG_KEYS` (the
    ``pack_config`` key order), so a packed flat config and the space
    enumerate identically.  Cached: the space is immutable.
    """
    axes = []
    for cls, table, group in (
        (HadoopParams, "Table 1", "params"),
        (ProfileStats, "Table 2", "stats"),
        (CostFactors, "Table 3", "costs"),
    ):
        for f in dataclasses.fields(cls):
            lower, upper, lo_open = _HADOOP_BOUNDS.get(f.name, (0, None, False))
            axes.append(Axis(
                name=f.name,
                kind=_kind_of(f),
                lower=lower,
                upper=upper,
                lower_open=lo_open,
                unit=_HADOOP_UNITS.get(f.name, ""),
                table=table,
                group=group,
            ))
    return ParamSpace(axes)
