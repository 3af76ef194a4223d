"""Dense GQA transformer on PyTorch tensors (port of `repro.models`)."""
