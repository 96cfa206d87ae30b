"""Launch scripts: ``serve`` (``python -m repro_torch serve``) and the
config presets."""
