"""Analytic models the serving engine checks its measurements against."""
