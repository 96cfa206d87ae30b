"""The model: config, layers, KV and SSM caches, attention, Mamba-2, MoE,
parameter init, the decoder stack and the single-program ``Model``."""
