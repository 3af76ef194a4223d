"""Serving policy: token trees, request pool, latency model, routing,
scheduling and admission (framework-free copies of `repro.core`)."""
