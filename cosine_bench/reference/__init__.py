"""Plain PyTorch references of the served architectures, one module a
family, each with `param_specs(cfg)` and `forward(cfg, params, tokens,
out_positions, control=False)`."""
