"""Launchers: mesh construction, the AFD dry-run (each role's per-device
program priced by its roofline terms, and measured on the card), and the
end-to-end entry points ``serve`` (``python -m repro_torch serve``), ``train``
(``python -m repro_torch train``) and the config presets."""
