"""Serving: the single-program ``DecodeEngine``, the two-role AFD engine,
their scheduler policy and the traffic model."""
