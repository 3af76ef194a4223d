"""Analytic FLOP and HBM-byte models (port of `repro.analysis`)."""
