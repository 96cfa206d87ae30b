"""Launch scripts: ``serve`` (``python -m repro_torch serve``), ``train``
(``python -m repro_torch train``) and the config presets."""
