"""Front door of the port's analysis layer (``repro.api``'s counterpart)."""
