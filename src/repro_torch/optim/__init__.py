"""Optimizers of the port (port of ``repro.optim``): AdamW."""
