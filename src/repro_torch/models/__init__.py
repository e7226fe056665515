"""repro_torch.models — the LM substrate: config, layers, attention over
full and ring KV caches, the decoder-only :class:`LM` (served and trained),
its weights and the §Perf flags.  Families beyond dense attention come in
later slices (``ROADMAP.md`` queue 1)."""
