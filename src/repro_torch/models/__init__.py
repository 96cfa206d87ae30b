"""Model pieces of the AFD path: config, layers, KV cache, attention,
MoE routing and parameter init."""
