"""Serving layer: slot-cache model runners, the execution backend and
the speculative engine."""
