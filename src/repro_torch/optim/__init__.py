"""Optimizers over the port's parameter trees (port of `repro.optim`)."""
