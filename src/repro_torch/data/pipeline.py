"""Deterministic, shardable synthetic-token data pipeline.

The port's copy of the reference's framework-free ``repro/data/pipeline.py``
(numpy only), pinned bit for bit to it by ``tests/test_torch_training.py``:
the same batches and checksums for the same seed and step.  Batches are
numpy arrays; the train step moves them to its device.

Design rules (all load-bearing for fault tolerance at scale):

* **Stateless indexing** — batch ``step`` is a pure function of
  ``(seed, step)``: ``batch = f(seed, step)``.  Resume after failure needs
  no data-iterator checkpoint; a restored trainer at step k reproduces the
  exact token stream an uninterrupted run would have seen (tested
  bit-exactly in the reference's ``tests/test_fault_tolerance.py``).
* **Host sharding** — each host materializes only its slice of the global
  batch (``host_index / num_hosts``), the standard multi-pod input layout;
  ``global_batch`` must divide evenly.
* **Structured synthetic text** — tokens follow a mixed Markov/copy process
  (not iid noise) so language models actually have signal to learn: the
  e2e example's loss curve drops measurably within a few hundred steps.
* Labels are inputs shifted by one, with a loss mask that zeroes padding
  and the BOS position — the ``{"inputs","targets","mask"}`` contract of
  ``lm.loss_fn``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["PipelineConfig", "TokenPipeline"]


@dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    # synthetic process parameters
    n_states: int = 64            # Markov states
    copy_period: int = 97         # every k-th position copies an earlier token


class TokenPipeline:
    """Deterministic synthetic corpus with next-token structure."""

    def __init__(self, cfg: PipelineConfig):
        assert cfg.global_batch % cfg.num_hosts == 0, (
            "global batch must shard evenly over hosts"
        )
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        # fixed random Markov transition table (vocab partitioned by state)
        rng = np.random.default_rng(cfg.seed)
        self._trans = rng.integers(
            0, cfg.n_states, size=(cfg.n_states, 4), dtype=np.int64
        )
        self._state_vocab = rng.integers(
            2, cfg.vocab_size, size=(cfg.n_states, 8), dtype=np.int64
        )

    # ------------------------------------------------------------- batches
    def _sequences(self, step: int, rows: np.ndarray, length: int | None = None) -> np.ndarray:
        """Generate token rows for global row indices (vectorized Markov)."""
        cfg = self.cfg
        S = cfg.seq_len if length is None else length
        n = rows.shape[0]
        # Counter-based randomness keyed by (seed, step, GLOBAL row, t):
        # identical streams regardless of how rows are sharded over hosts.
        with np.errstate(over="ignore"):  # uint64 wraparound is the hash
            base = (
                rows.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
                + np.uint64((step * 0xBF58476D1CE4E5B9) % (1 << 64))
                + np.uint64((cfg.seed * 0x94D049BB133111EB) % (1 << 64))
            )
            t_idx = np.arange(S, dtype=np.uint64)
            mix = base[:, None] + t_idx[None, :] * np.uint64(0xD6E8FEB86659FD93)
            mix ^= mix >> np.uint64(33)
            mix *= np.uint64(0xFF51AFD7ED558CCD)
            mix ^= mix >> np.uint64(29)
        pick = (mix % np.uint64(4)).astype(np.int64)
        emit = ((mix >> np.uint64(8)) % np.uint64(8)).astype(np.int64)

        seeds = (rows.astype(np.int64) * 2_654_435_761 + step * 97) % (1 << 31)
        state = seeds % cfg.n_states
        toks = np.empty((n, S), np.int64)
        for t in range(S):
            toks[:, t] = self._state_vocab[state, emit[:, t]]
            state = self._trans[state, pick[:, t]]
        # copy structure: position t takes the token from t - period
        per = cfg.copy_period
        for t in range(per, S, per):
            toks[:, t] = toks[:, t - per]
        toks[:, 0] = 1  # BOS
        return toks

    def batch(self, step: int) -> dict:
        """This host's shard of global batch ``step``."""
        cfg = self.cfg
        lo = self.cfg.host_index * self.local_batch
        rows = np.arange(lo, lo + self.local_batch, dtype=np.int64)
        toks = self._sequences(step, rows, length=cfg.seq_len + 1)
        inputs = toks[:, :-1]
        targets = toks[:, 1:]
        mask = (targets != 0).astype(np.float32)
        return {
            "inputs": inputs.astype(np.int32),
            "targets": targets.astype(np.int32),
            "mask": mask,
        }

    def global_batch_checksum(self, step: int) -> int:
        """Host-layout-independent checksum (tested: 1 host == 4 hosts)."""
        cfg = self.cfg
        rows = np.arange(cfg.global_batch, dtype=np.int64)
        toks = self._sequences(step, rows)
        return int(np.bitwise_xor.reduce(toks.ravel() * (rows.sum() + 1)) )
