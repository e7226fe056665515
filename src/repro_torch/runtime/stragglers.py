"""Straggler detection + speculative re-dispatch (Hadoop-style, pure).

The port's copy of the reference's framework-free
``repro/runtime/stragglers.py``, pinned to it by
``tests/test_torch_trainer.py``.

Hadoop's speculative execution launches a duplicate of a task whose
*progress rate* lags the fleet; the first copy to finish wins.  In data-
parallel training the analogous unit is a *host* whose step time lags
(failing memory, thermal throttling, a noisy neighbour on the host NIC):
the synchronous collective makes EVERY rank wait for the slowest, so one
straggler throttles the whole job, for the same reason one slow map task
delays every reducer past the slowstart point.

The decision function is pure, consumed by two users:

* the **task-scheduler simulator** (``core/hadoop/simulator.py``) for
  wave-level what-if analysis;
* the **Trainer** (:mod:`repro_torch.runtime.train_loop`), which tracks
  per-step times and surfaces `should_speculate`-positive hosts so that an
  external orchestrator can re-dispatch their shard (elastic restore makes
  that possible); in one process the hook records the step.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["should_speculate", "StragglerDetector"]


def should_speculate(
    progress_rate: float,
    fleet_mean_rate: float,
    fleet_std_rate: float,
    *,
    remaining_work: float,
    est_fresh_time: float,
    slowness_sigmas: float = 1.0,
    min_remaining_ratio: float = 1.2,
) -> bool:
    """Hadoop's LATE-style heuristic.

    Launch a speculative copy iff the task is (a) significantly slower than
    the fleet — ``rate < mean - k*std`` — and (b) restarting is actually
    cheaper: projected remaining time exceeds a fresh execution estimate by
    ``min_remaining_ratio``.
    """
    if progress_rate <= 0:
        return True
    slow = progress_rate < fleet_mean_rate - slowness_sigmas * fleet_std_rate
    projected_remaining = remaining_work / progress_rate
    worth_it = projected_remaining > min_remaining_ratio * est_fresh_time
    return bool(slow and worth_it)


@dataclass
class StragglerDetector:
    """Per-worker EWMA step times + outlier flagging for the train loop."""

    alpha: float = 0.2
    sigmas: float = 3.0
    warmup: int = 5
    rel_margin: float = 0.5   # never flag < (1+rel_margin) x EWMA (var->0 guard)
    _ewma: dict = field(default_factory=dict)
    _var: dict = field(default_factory=dict)
    _count: dict = field(default_factory=dict)

    def observe(self, worker: str, step_time: float) -> bool:
        """Record a step time; True when this worker looks like a straggler."""
        n = self._count.get(worker, 0)
        mu = self._ewma.get(worker, step_time)
        var = self._var.get(worker, 0.0)
        is_straggler = False
        if n >= self.warmup:
            sd = max(var, 1e-12) ** 0.5
            thr = mu + max(self.sigmas * sd, self.rel_margin * mu)
            is_straggler = step_time > thr
        # EWMA update (skip updating stats with the outlier itself)
        if not is_straggler:
            delta = step_time - mu
            mu = mu + self.alpha * delta
            var = (1 - self.alpha) * (var + self.alpha * delta * delta)
        self._ewma[worker] = mu
        self._var[worker] = var
        self._count[worker] = n + 1
        return is_straggler

    def fleet_stats(self) -> tuple[float, float]:
        if not self._ewma:
            return 0.0, 0.0
        vals = list(self._ewma.values())
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / max(len(vals), 1)
        return mean, var ** 0.5
