"""repro_torch.models — the LM substrate's serving path: config, layers,
attention over full and ring KV caches, the decoder-only :class:`LM`, and
its weights.  Families beyond dense attention come in later slices
(``ROADMAP.md`` queue 1)."""
