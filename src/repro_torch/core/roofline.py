"""Roofline terms from a traced or compiled step.

The port's copy of the reference's framework-free ``repro/core/roofline.py``.
The paper's Eq. 98 -- ``Cost = IOCost + CPUCost + NETCost`` -- as three
per-device terms of an accelerator step:

    compute term    = FLOPs           / peak FLOP/s
    memory term     = HBM bytes       / HBM bytes/s
    collective term = collective wire / link bytes/s

The HLO parser (:class:`_Program`, :func:`collective_bytes`,
:func:`hlo_totals`) is the reference's, kept intact so that it reads the
reference's compiled artifacts and gives its answers.  The port's own
dry-run (:mod:`repro_torch.launch.dryrun`) counts FLOPs, bytes and
collectives while it traces and feeds them to :func:`roofline_terms`
through the same :class:`CollectiveStats` and :data:`_WIRE_FACTOR`.

The hardware rates are a parameter: :data:`HW_TABLES` holds one entry per
device, and ``hw=None`` means :data:`HW`, the reference's own table, so
every default answer equals the reference's.  ``"h100_sxm"`` holds NVIDIA's
published data-sheet figures for the H100 SXM5 80GB at 700 W, not a
measurement.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

__all__ = [
    "HW",
    "HW_TABLES",
    "RooflineTerms",
    "collective_bytes",
    "hw_table",
    "roofline_terms",
    "model_flops",
]

#: per-device rates by hardware name: ``peak_flops`` (bf16 FLOP/s),
#: ``hbm_bw`` (B/s), ``ici_bw`` (B/s of one link, one direction)
HW_TABLES = {
    # the reference's table (repro/core/roofline.py), kept for parity
    "tpu_v5e": {
        "peak_flops": 197e12,
        "hbm_bw": 819e9,
        "ici_bw": 50e9,
    },
    # NVIDIA's published H100 SXM5 80GB figures (700 W): dense bf16 tensor
    # cores, HBM3, NVLink 4 in one direction; not a measurement
    "h100_sxm": {
        "peak_flops": 989e12,
        "hbm_bw": 3.35e12,
        "ici_bw": 450e9,
    },
}
#: the default table: the reference's
HW = HW_TABLES["tpu_v5e"]


def hw_table(hw: str | dict | None) -> dict:
    """``None`` -> :data:`HW`; a name -> its :data:`HW_TABLES` entry; a
    dict is taken as it is."""
    if hw is None:
        return HW
    if isinstance(hw, str):
        if hw not in HW_TABLES:
            raise KeyError(f"unknown hardware {hw!r}; known: {sorted(HW_TABLES)}")
        return HW_TABLES[hw]
    return hw


_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

# bytes-on-the-wire factor per collective kind (ring algorithms, large N),
# applied to the RESULT shape bytes.  reduce-scatter's result is 1/N of the
# reduced tensor while each device still moves ~the full input over the ring,
# so its factor is the replica-group size (parsed per instruction).
_WIRE_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": None,     # group-size dependent: result x N
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "ragged-all-to-all": 1.0,
}

_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_EXPL_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")


def _group_size(line: str) -> int:
    """Replica-group size of a collective (iota or explicit format)."""
    m = _GROUPS_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_EXPL_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 1

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\)|[a-z0-9\[\],{}\s]*?))\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|ragged-all-to-all|"
    r"collective-permute)(?:-start)?\("
)


def _shape_bytes(text: str) -> int:
    """Sum byte sizes of every dtype[shape] token in a result description."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveStats:
    total_bytes: float = 0.0
    by_kind: dict = field(default_factory=dict)
    count: int = 0


_HEADER_RE = re.compile(r"^\s*(?:ENTRY\s+)?(%?[\w\.\-]+)\s*\(.*->.*\{\s*$")


def _computations(hlo: str) -> dict[str, list[str]]:
    """Split HLO text into computation name -> list of body lines."""
    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo.splitlines():
        m = _HEADER_RE.match(line)
        if m:
            cur = m.group(1).lstrip("%")
            comps[cur] = []
            continue
        if cur is not None:
            if line.strip() == "}":
                cur = None
            else:
                comps[cur].append(line)
    return comps


def _trip_count(cond_lines: list[str]) -> int:
    """Recover a scan trip count from the loop condition's compare constant."""
    consts = []
    for ln in cond_lines:
        if "constant(" in ln and ("s32" in ln or "s64" in ln or "u32" in ln):
            for m in re.finditer(r"constant\((-?\d+)\)", ln):
                consts.append(int(m.group(1)))
    pos = [c for c in consts if c > 0]
    return max(pos) if pos else 1


class _Program:
    """Parsed post-optimization HLO: computations + loop-trip multiplicity."""

    def __init__(self, hlo: str):
        self.comps = _computations(hlo)
        self.body_trips: dict[str, int] = {}
        while_re = re.compile(
            r"while\(.*?\),\s*condition=%?([\w\.\-]+),\s*body=%?([\w\.\-]+)"
        )
        trip_re = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
        call_re = re.compile(r"(?:condition|body|to_apply|calls)=%?([\w\.\-]+)")
        self.callers: dict[str, list[str]] = {c: [] for c in self.comps}
        self.fused: set[str] = set()
        fusion_re = re.compile(r"fusion\(.*?calls=%?([\w\.\-]+)")
        for cname, lines in self.comps.items():
            for ln in lines:
                m = while_re.search(ln)
                if m:
                    cond, body = m.group(1), m.group(2)
                    tm = trip_re.search(ln)
                    if tm:
                        # XLA annotates analyzed loops explicitly — use it.
                        self.body_trips[body] = int(tm.group(1))
                    else:
                        # fall back: compare-constant in the loop condition.
                        self.body_trips[body] = _trip_count(
                            self.comps.get(cond, [])
                        )
                for fm in fusion_re.finditer(ln):
                    self.fused.add(fm.group(1))
                for cm in call_re.finditer(ln):
                    callee = cm.group(1)
                    if callee in self.callers:
                        self.callers[callee].append(cname)
        self._mult: dict[str, float] = {}

    def eff_mult(self, name: str, depth: int = 0) -> float:
        """Total times this computation executes (nested scan trip counts)."""
        if depth > 16:
            return 1.0
        if name in self._mult:
            return self._mult[name]
        own = self.body_trips.get(name, 1)
        ups = self.callers.get(name, [])
        parent = max((self.eff_mult(u, depth + 1) for u in ups), default=1.0)
        self._mult[name] = own * parent
        return self._mult[name]

    def symbols(self, lines: list[str]) -> dict[str, int]:
        """instruction name -> result bytes, for operand lookups."""
        table: dict[str, int] = {}
        for ln in lines:
            m = re.match(r"\s*(ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.+?)\s[a-z][\w\-]*\(", ln)
            if m:
                table[m.group(2)] = _shape_bytes(m.group(3))
        return table


def collective_bytes(hlo: str) -> CollectiveStats:
    """Per-device bytes moved by collectives in post-partitioning HLO,
    weighted by scan trip counts."""
    prog = _Program(hlo)
    stats = CollectiveStats()
    for cname, lines in prog.comps.items():
        mult = prog.eff_mult(cname)
        for ln in lines:
            m = _COLL_RE.search(ln)
            if not m:
                continue
            result_txt, kind = m.group(1), m.group(2)
            size = _shape_bytes(result_txt)
            if size == 0:
                size = _shape_bytes(ln.split("=")[0])
            factor = _WIRE_FACTOR.get(kind, 1.0)
            if factor is None:  # reduce-scatter: wire ~ full input
                factor = float(_group_size(ln))
            wire = size * factor * mult
            stats.total_bytes += wire
            stats.by_kind[kind] = stats.by_kind.get(kind, 0.0) + wire
            stats.count += 1
    return stats


_DOT_RE = re.compile(
    r"=\s*([a-z0-9]+)\[([0-9,]*)\][^ ]*\s+dot\(%?([\w\.\-]+),\s*%?([\w\.\-]+)\)"
    r".*?lhs_contracting_dims=\{([0-9,]*)\}"
)
_SHAPE_OF = re.compile(r"%?([\w\.\-]+)\s*=\s*[a-z0-9]+\[([0-9,]*)\]")
_NO_TRAFFIC = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "iota",
}
_OP_RE = re.compile(r"=\s*.*?\s([a-z][\w\-]*)\(")


def hlo_totals(hlo: str) -> dict:
    """Trip-count-weighted PER-DEVICE totals parsed from post-opt HLO.

    The XLA:CPU ``cost_analysis()`` counts each while body ONCE, wildly
    undercounting lax.scan programs (layer stacks, grad accumulation).
    This parser multiplies per-computation contributions by the recovered
    loop trip counts.  The post-partitioning module is the per-device
    program, so every total here is per-chip.

    * ``dot_flops``: 2 * prod(result) * contracted-dims for every dot,
      weighted by trip count (fusion bodies inherit their caller's count).
    * ``out_bytes_w`` / ``out_bytes_1``: result bytes of every traffic-
      carrying instruction, trip-weighted and counted-once respectively.
      Their ratio is the loop-undercount correction applied to XLA's own
      ``bytes accessed`` (which models fusion operand slicing correctly but
      visits each while body once).  Operand bytes are deliberately NOT
      attributed here: a fusion reading a dynamic slice of a stacked
      loop-carry array would otherwise be charged the whole array per
      iteration.
    """
    prog = _Program(hlo)

    # global tables for operand lookups (instruction names are unique)
    dims_of: dict[str, list[int]] = {}
    decl_re = re.compile(
        r"%?([\w\.\-]+)\s*=\s*((?:\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^\s]*))\s"
    )
    for lines in prog.comps.values():
        for ln in lines:
            sm = _SHAPE_OF.search(ln)
            if sm:
                dims_of[sm.group(1)] = [
                    int(x) for x in sm.group(2).split(",") if x
                ] or [1]

    dot_flops = 0.0
    out_w = 0.0
    out_1 = 0.0
    for cname, lines in prog.comps.items():
        mult = prog.eff_mult(cname)
        in_fused = cname in prog.fused
        for ln in lines:
            dm = _DOT_RE.search(ln)
            if dm:
                out_dims = [int(x) for x in dm.group(2).split(",") if x] or [1]
                cdims = [int(x) for x in dm.group(5).split(",") if x]
                lhs_dims = dims_of.get(dm.group(3), [1])
                contracted = 1
                for c in cdims:
                    if c < len(lhs_dims):
                        contracted *= lhs_dims[c]
                n_out = 1
                for d in out_dims:
                    n_out *= d
                dot_flops += 2.0 * n_out * contracted * mult
            if in_fused:
                continue
            om = _OP_RE.search(ln)
            if not om or om.group(1) in _NO_TRAFFIC:
                continue
            dc = decl_re.search(ln)
            out_b = _shape_bytes(dc.group(2)) if dc else 0
            out_w += out_b * mult
            out_1 += out_b
    return {"dot_flops": dot_flops, "out_bytes_w": out_w, "out_bytes_1": out_1}


@dataclass
class RooflineTerms:
    """All byte/FLOP fields are PER-DEVICE; global = per-device x chips.

    Equivalently (the task formulas): compute_s = HLO_FLOPs_global /
    (chips x peak) — identical because HLO_FLOPs_global = flops x chips.
    """

    flops: float                 # per-device HLO flops
    hbm_bytes: float             # per-device HBM bytes accessed
    coll_bytes: float            # per-device collective wire bytes
    chips: int
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bound: str = ""
    model_flops: float = 0.0     # global useful flops (6*N*D style)
    useful_ratio: float = 0.0    # model_flops / (flops x chips)

    def finalize(self, hw: str | dict | None = None) -> "RooflineTerms":
        rates = hw_table(hw)
        self.compute_s = self.flops / rates["peak_flops"]
        self.memory_s = self.hbm_bytes / rates["hbm_bw"]
        self.collective_s = self.coll_bytes / rates["ici_bw"]
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.bound = max(terms, key=terms.get)
        if self.flops > 0 and self.model_flops > 0:
            self.useful_ratio = self.model_flops / (self.flops * self.chips)
        return self


def roofline_terms(
    cost: dict,
    coll: CollectiveStats,
    chips: int,
    model_fl: float = 0.0,
    parsed: dict | None = None,
    hw: str | dict | None = None,
) -> RooflineTerms:
    """Combine XLA cost_analysis with the trip-count-weighted HLO parse.

    * FLOPs: the parsed dot census is exact per dot and trip-weighted; XLA's
      number visits while bodies once.  Take the max (non-dot flops only
      matter in programs with no loops, where cost_analysis wins).
    * bytes: XLA's per-instruction accounting is better (it models fusion
      operand slicing), but suffers the same once-per-while undercount —
      scale it by the parsed output-bytes ratio (weighted / once).

    ``hw``: a :data:`HW_TABLES` name or a rates dict; None is :data:`HW`.
    """
    flops = float(cost.get("flops", 0.0) or 0.0)
    bytes_ = float(cost.get("bytes accessed", 0.0) or 0.0)
    if parsed:
        flops = max(flops, float(parsed.get("dot_flops", 0.0)))
        if "out_bytes_w" in parsed:
            ratio = parsed["out_bytes_w"] / max(parsed.get("out_bytes_1", 1.0), 1.0)
            bytes_ = bytes_ * max(ratio, 1.0)
        else:  # legacy artifact
            bytes_ = max(bytes_, float(parsed.get("hbm_bytes", 0.0)))
    rt = RooflineTerms(
        flops=flops, hbm_bytes=bytes_, coll_bytes=coll.total_bytes,
        chips=chips, model_flops=model_fl,
    )
    return rt.finalize(hw)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for training cells;
    2*N*D-style forward cost for serving cells (per step)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    # active params per token (attention + ffn + embeddings out)
    attn = 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * L
    if cfg.n_experts:
        ff_active = 3 * d * cfg.d_expert * (cfg.moe_top_k + cfg.n_shared_experts)
        ff = ff_active * (L - cfg.moe_layer_start) + 3 * d * (cfg.d_ff_dense or cfg.d_ff) * cfg.moe_layer_start
    elif "ssm" in cfg.layer_pattern:
        d_in = cfg.d_inner_ssm
        ff = 0.0
        attn = L * (d * (2 * d_in + 2 * cfg.ssm_state + cfg.n_ssm_heads) + d_in * d)
    else:
        n_mlp = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        ff = n_mlp * d * cfg.d_ff * L
        if "rglru" in cfg.layer_pattern:
            # rglru layers replace attention with recurrent params
            n_rec = sum(
                1 for i in range(cfg.n_layers)
                if (cfg.prefix_pattern + cfg.layer_pattern * cfg.n_groups)[i] == "rglru"
            )
            rec = n_rec * (2 * d * cfg.d_rnn + 2 * cfg.d_rnn * cfg.d_rnn + cfg.d_rnn * d)
            attn = attn * (L - n_rec) / L + rec
    n_active = attn + ff + d * V  # + unembed
    tokens = shape.global_batch * shape.seq_len
    if cfg.is_encdec:
        n_active *= 2.0  # encoder + decoder stacks
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * shape.global_batch
