"""Provisioning of the port: the analytic-vs-measured calibration."""
