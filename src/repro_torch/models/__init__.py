"""repro_torch.models — the LM substrate: config, layers, attention over
full and ring KV caches, the MoE, SSD and RG-LRU blocks, the decoder-only
:class:`LM` and the encoder-decoder :class:`EncDec` (served and trained),
their weights and the §Perf flags."""
