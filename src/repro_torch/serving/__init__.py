"""Serving: the two-role engine, its scheduler policy and the traffic
model."""
