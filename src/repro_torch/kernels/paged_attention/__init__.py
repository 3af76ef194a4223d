"""Attention partials over a paged KV pool on Hopper (port of the Pallas
kernel `repro.kernels.decode_attention.kernel.paged_flash_decode`)."""
