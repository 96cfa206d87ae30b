"""The two-role AFD runtime."""
