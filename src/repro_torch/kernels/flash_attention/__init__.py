"""Flash-attention partials on Hopper (port of the Pallas kernel
`repro.kernels.common.flash_attention_partial`)."""
