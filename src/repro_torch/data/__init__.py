"""Synthetic multi-domain corpus (a framework-free copy of
`repro.data`)."""
