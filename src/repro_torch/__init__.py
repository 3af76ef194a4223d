"""PyTorch/CUDA port of the CoSine serving system (`repro`).

The JAX package `repro` is the reference; this package re-implements its
main serving path — the `cosine` strategy on the simulated backend over a
dense GQA target and dense GQA drafters on the resident slot cache — on
PyTorch, with the attention of every forward pass running a hand-written
Hopper kernel (`kernels/flash_attention`). It never imports `jax` or
`repro`; framework-free modules are kept here as copies.

Entry points (`SpeculativeEngine`, `ModelRunner`, `init_params`,
`init_cache`) run on CUDA unless the caller passes `device="cpu"`.
"""
