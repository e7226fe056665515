"""The paper's analytical performance models applied to an accelerator step.

The port's copy of the reference's framework-free ``repro/core/tpu_model.py``
(the arithmetic is the reference's, line for line).  The paper predicts
MapReduce job cost from three parameter groups (Hadoop config / profile
statistics / cost factors) by decomposing execution into phases and summing
per-phase closed-form costs (Eq. 98: ``Cost = IOCost + CPUCost +
NETCost``).  This module is the same methodology for a training or serving
step on a mesh of accelerators:

  Table-1 analogue : :class:`TpuParams` -- mesh axes, microbatch count,
                     remat policy, activation dtype, sharding strategy.
  Table-2 analogue : derived *dataflow statistics* per phase -- tensor
                     sizes/FLOPs from the architecture config x input shape
                     (the "profile" is exact here: shapes are static).
  Table-3 analogue : :class:`TpuCostFactors` -- peak FLOP/s, HBM B/s, link
                     B/s, plus dimensionless efficiency factors that can be
                     *fitted* from dry-run artifacts exactly the way
                     Starfish fits Table 3 from live task timings.
                     :meth:`TpuCostFactors.for_hw` takes the three rates
                     from a :data:`repro_torch.core.roofline.HW_TABLES`
                     entry; the defaults are the reference's table.

  Phases (map/reduce analogue): embed -> per-layer {qkv, attn, proj,
  mlp|moe(+dispatch shuffle)} -> logits -> loss -> backward(2x) ->
  grad-reduce -> optimizer.  Each phase yields (flops, hbm bytes,
  collective bytes) per device; Eq. 98's three terms fall out by dividing
  by the three hardware rates, and the job-level composition over
  microbatches mirrors Eqs. 92-97 (waves of tasks -> sequential
  microbatches on the same chips).

Two quirks of the reference are kept, so that the port answers as it does
(``ROADMAP.md`` queue 3): :func:`_param_count` halves the attention
projections' parameters, and the ``lg_tokens`` branch of
:func:`step_model`'s logits phase picks ``t_dev`` on every path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.roofline import HW, hw_table
from repro_torch.models.config import ModelConfig

__all__ = ["TpuParams", "TpuCostFactors", "PhaseCost", "StepModel", "step_model"]


@dataclass(frozen=True)
class TpuParams:
    """Table-1 analogue: the tunable execution configuration."""
    dp: int = 16                  # data-parallel ways (pod x data)
    tp: int = 16                  # tensor/model-parallel ways
    n_micro: int = 8              # gradient-accumulation microbatches
    remat: bool = True            # recompute activations in backward
    act_bytes: int = 2            # bf16 activations
    grad_bytes: int = 4           # fp32 grad accumulators / collectives
    param_bytes: int = 4          # fp32 master params
    seq_shard: bool = False       # sequence-parallel norm/residual regions
    ep: int = 1                   # expert-parallel ways (<= tp)

    @property
    def chips(self) -> int:
        return self.dp * self.tp


@dataclass(frozen=True)
class TpuCostFactors:
    """Table-3 analogue.  Efficiency factors default to 1 (pure roofline)
    and are fitted from dry-run artifacts (the reference fits them in
    benchmarks/bench_tpu_model)."""
    peak_flops: float = HW["peak_flops"]
    hbm_bw: float = HW["hbm_bw"]
    ici_bw: float = HW["ici_bw"]
    # dimensionless fudge factors (≥1 inflates cost), fitted like Table 3:
    eff_compute: float = 1.0      # MXU utilization / padding waste
    eff_memory: float = 1.0       # fusion quality (re-reads of activations)
    eff_collective: float = 1.0   # link utilization / latency

    @classmethod
    def for_hw(cls, name: str, **eff: float) -> "TpuCostFactors":
        """The three rates from ``HW_TABLES[name]``; ``eff`` sets the
        efficiency factors (default 1)."""
        rates = hw_table(name)
        return cls(peak_flops=rates["peak_flops"], hbm_bw=rates["hbm_bw"],
                   ici_bw=rates["ici_bw"], **eff)


@dataclass
class PhaseCost:
    """Per-phase (FLOPs, HBM bytes, collective bytes) — per device."""
    name: str
    flops: float = 0.0
    hbm: float = 0.0
    coll: float = 0.0

    def scaled(self, k: float) -> "PhaseCost":
        return PhaseCost(self.name, self.flops * k, self.hbm * k, self.coll * k)


@dataclass
class StepModel:
    """Job-level model: phase list + the paper's three cost terms."""
    phases: list = field(default_factory=list)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        """Eq. 98 analogue — upper bound without overlap."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def overlap_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def _layer_counts(cfg: ModelConfig) -> dict:
    """How many layers of each mixer kind the model has."""
    kinds = list(cfg.prefix_pattern)
    if cfg.n_experts and cfg.moe_layer_start:
        kinds += ["attn"] * cfg.moe_layer_start
    n_scan = cfg.n_layers - len(kinds)
    reps = n_scan // cfg.pattern_len
    for k in cfg.layer_pattern:
        kinds += [k] * reps
    out: dict[str, int] = {}
    for k in kinds:
        out[k] = out.get(k, 0) + 1
    return out


def step_model(
    cfg: ModelConfig,
    shape,                        # repro_torch.configs.shapes.ShapeSpec
    tp_params: TpuParams,
    costs: TpuCostFactors = TpuCostFactors(),
) -> StepModel:
    """Phase-decomposed analytical cost of one train/serve step.

    Dataflow statistics are exact (static shapes); the model's job is the
    same as the paper's: predict the three resource terms for a *candidate
    configuration without running it*, so a tuner can search the config
    space (see :mod:`repro_torch.search.tpu`).
    """
    P = tp_params
    d, V = cfg.d_model, cfg.vocab_size
    ab, gb, pb = P.act_bytes, P.grad_bytes, P.param_bytes
    is_train = shape.kind == "train"
    # tokens processed per device per microbatch
    if shape.kind == "decode":
        tokens_global = shape.global_batch          # one token per sequence
    else:
        tokens_global = shape.global_batch * shape.seq_len
    t_dev = tokens_global / max(P.dp, 1) / max(P.n_micro if is_train else 1, 1)

    counts = _layer_counts(cfg)
    phases: list[PhaseCost] = []

    def add(name, flops=0.0, hbm=0.0, coll=0.0):
        phases.append(PhaseCost(name, flops, hbm, coll))

    # ---------------- embed ----------------
    add("embed", hbm=t_dev * d * ab + t_dev * 4)     # gather reads + ids

    # ---------------- per-layer phases ----------------
    n_attn = counts.get("attn", 0) + counts.get("local", 0) + counts.get("attn_dense", 0)
    n_rglru = counts.get("rglru", 0)
    n_ssm = counts.get("ssm", 0)

    # GSPMD divisibility rule: a head dim that the tp axis does not divide
    # is REPLICATED (XLA's "involuntary full rematerialization") — the
    # model charges the full head count, which is exactly what the
    # starcoder2 dry-run measured (36 heads at tp=16; §Perf Cell C).
    def _shard(n: int) -> int:
        tp = max(P.tp, 1)
        if not n:
            return 0
        if n % tp == 0:
            return n // tp
        if tp % n == 0:
            return 1          # partial shard + replicate groups (kv=8@tp=16)
        return n              # incompatible -> GSPMD replicates (36@tp=16)

    heads_dev = _shard(cfg.n_heads)
    kv_dev = _shard(cfg.n_kv_heads)
    hd = cfg.head_dim

    if n_attn:
        # qkv+proj matmuls (TP-sharded over heads)
        w_qkvo = d * (heads_dev + 2 * kv_dev + heads_dev) * hd
        add(
            "attn_proj",
            flops=n_attn * 2.0 * t_dev * w_qkvo,
            hbm=n_attn * (w_qkvo * pb + t_dev * (2 * d) * ab),
        )
        # scores+values: seq_len context per token (window for local layers)
        ctx_full = shape.seq_len
        n_local = counts.get("local", 0)
        n_global = n_attn - n_local
        ctx_local = min(cfg.window_size, shape.seq_len)
        att_fl = 2.0 * 2.0 * t_dev * hd * heads_dev
        add(
            "attn_scores",
            flops=att_fl * (n_global * ctx_full + n_local * ctx_local) / 2
            if shape.kind != "decode"
            else att_fl * (n_global * ctx_full + n_local * ctx_local),
            hbm=(n_global * ctx_full + n_local * ctx_local)
            * kv_dev * hd * ab * (2 if shape.kind == "decode" else 0)
            + n_attn * t_dev * hd * heads_dev * ab * 2,
        )
        # TP collective: 2 all-reduces (attn out + mlp out) per layer in
        # Megatron layout = 2 x 2x activation bytes (ring) — fwd; bwd adds 2.
        if P.tp > 1:
            ar = 2.0 * t_dev * d * (gb if is_train else ab)
            add("tp_allreduce", coll=n_attn * 2 * ar)

    if n_rglru:
        dr = cfg.d_rnn
        # Griffin block: two d->dr input branches + dr->d out proj; the
        # RG-LRU gates themselves are diagonal (O(dr) per token, negligible)
        w = (2 * d * dr + dr * d) / max(P.tp, 1)
        add(
            "rglru",
            flops=n_rglru * 2.0 * t_dev * w,
            hbm=n_rglru * (w * pb + t_dev * (d + dr) * ab * 2),
        )
    if n_ssm:
        din = cfg.d_inner_ssm
        w = d * (2 * din + 2 * cfg.ssm_state + cfg.n_ssm_heads) + din * d
        add(
            "ssm",
            flops=n_ssm * 2.0 * t_dev * (w / max(P.tp, 1))
            + n_ssm * 2.0 * t_dev * din * cfg.ssm_state * 2 / max(P.tp, 1),
            hbm=n_ssm * (w * pb / max(P.tp, 1) + t_dev * din * ab * 4),
        )

    # ---------------- FFN / MoE ----------------
    if cfg.n_experts:
        n_moe = cfg.n_layers - cfg.moe_layer_start
        k_act = cfg.moe_top_k + cfg.n_shared_experts
        ff_w = 3 * d * cfg.d_expert          # swiglu expert
        cap = cfg.moe_capacity_factor
        # ideal: only top-k experts' flops per token (+ capacity padding)
        add(
            "moe_experts",
            flops=n_moe * 2.0 * t_dev * k_act * ff_w * cap,
            hbm=n_moe * (cfg.n_experts * ff_w * pb / max(P.ep, 1)
                         + t_dev * k_act * cfg.d_expert * ab * 2 * cap),
        )
        add("moe_router", flops=n_moe * 2.0 * t_dev * d * cfg.n_experts)
        # dispatch shuffle: all_to_all of top-k token activations (the
        # paper's Eq. 90 analogue — this IS the shuffle)
        if P.ep > 1:
            a2a = t_dev * cfg.moe_top_k * d * ab * cap
            add("moe_shuffle", coll=n_moe * 2.0 * a2a)  # there + back
        if cfg.moe_layer_start:
            w = 3 * d * (cfg.d_ff_dense or cfg.d_ff) / max(P.tp, 1)
            add("dense_ffn", flops=cfg.moe_layer_start * 2.0 * t_dev * w,
                hbm=cfg.moe_layer_start * w * pb)
    elif cfg.d_ff:
        n_ffn = n_attn + n_rglru
        n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        w = n_mats * d * cfg.d_ff / max(P.tp, 1)
        add(
            "ffn",
            flops=n_ffn * 2.0 * t_dev * w,
            hbm=n_ffn * (w * pb + t_dev * (cfg.d_ff / max(P.tp, 1)) * ab * 2),
        )

    # ---------------- norms/residuals (memory-only) ----------------
    add("norms_residuals", hbm=cfg.n_layers * t_dev * d * ab * 6)

    # ---------------- logits + loss ----------------
    v_dev = V / max(P.tp, 1)
    lg_tokens = t_dev if shape.kind != "prefill" else t_dev  # full logits
    if shape.kind == "decode":
        lg_tokens = t_dev
    add(
        "logits",
        flops=2.0 * lg_tokens * d * v_dev,
        hbm=d * v_dev * pb + lg_tokens * v_dev * 4,
    )
    if is_train:
        add("loss", hbm=lg_tokens * v_dev * 4 * 2)

    # ---------------- encoder stack (enc-dec) ----------------
    if cfg.is_encdec:
        # encoder ~ mirror of the decoder's attn+ffn phases (bidirectional)
        enc = [p.scaled(cfg.n_enc_layers / max(cfg.n_layers, 1))
               for p in phases if p.name in ("attn_proj", "attn_scores", "ffn")]
        for p in enc:
            add("encoder_" + p.name, p.flops, p.hbm, p.coll)

    # ---------------- backward + optimizer (train only) ----------------
    if is_train:
        bwd = []
        for p in phases:
            if p.name.startswith(("tp_allreduce", "moe_shuffle")):
                bwd.append(PhaseCost("bwd_" + p.name, 0, 0, p.coll))
            else:
                k = 2.0 + (1.0 if P.remat else 0.0)  # recompute fwd in bwd
                bwd.append(PhaseCost("bwd_" + p.name, p.flops * k,
                                     p.hbm * 2.0, 0.0))
        phases.extend(bwd)

        # parameter/optimizer traffic: params sharded over tp (and ep)
        n_params = _param_count(cfg)
        p_dev = n_params / max(P.tp, 1)
        add("optimizer", hbm=p_dev * (pb * 2 + gb * 2 + 8))  # m,v,p,g
        # DP gradient all-reduce (ring): 2x grad bytes, off-critical-path
        # per-microbatch if overlapped; modeled once per step.
        if P.dp > 1:
            add("grad_reduce", coll=2.0 * p_dev * gb)

    # ---------------- microbatch composition (Eqs. 92-97 analogue) -------
    n_rep = P.n_micro if is_train else 1
    total = StepModel(phases=phases)
    for p in phases:
        rep = 1 if p.name in ("optimizer", "grad_reduce") else n_rep
        total.compute_s += p.flops * rep / (costs.peak_flops / costs.eff_compute)
        total.memory_s += p.hbm * rep / (costs.hbm_bw / costs.eff_memory)
        total.collective_s += p.coll * rep / (costs.ici_bw / costs.eff_collective)
    return total


def _param_count(cfg: ModelConfig) -> float:
    d, V = cfg.d_model, cfg.vocab_size
    counts = _layer_counts(cfg)
    n_attn = counts.get("attn", 0) + counts.get("local", 0)
    n = V * d * (1 if cfg.tie_embeddings else 2)
    n += n_attn * d * (cfg.n_heads + 2 * cfg.n_kv_heads + cfg.n_heads) * cfg.head_dim / 2
    if cfg.n_experts:
        n += (cfg.n_layers - cfg.moe_layer_start) * cfg.n_experts * 3 * d * cfg.d_expert
        n += (cfg.n_layers - cfg.moe_layer_start) * cfg.n_shared_experts * 3 * d * cfg.d_expert
        n += cfg.moe_layer_start * 3 * d * (cfg.d_ff_dense or cfg.d_ff)
    elif cfg.d_ff:
        n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        n += (n_attn + counts.get("rglru", 0)) * n_mats * d * cfg.d_ff
    if counts.get("rglru"):
        dr = cfg.d_rnn
        n += counts["rglru"] * (2 * d * dr + dr * d + 2 * dr * dr)
    if counts.get("ssm"):
        din = cfg.d_inner_ssm
        n += counts["ssm"] * (d * (2 * din + 2 * cfg.ssm_state + cfg.n_ssm_heads) + din * d)
    if cfg.is_encdec:
        n *= 1.8
    return float(n)
