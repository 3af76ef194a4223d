"""Entry points: training and serving (port of `repro.launch`)."""
