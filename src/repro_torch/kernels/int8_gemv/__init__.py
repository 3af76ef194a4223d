"""Fused int8 dequantisation + GEMV on Hopper (port of the Pallas kernel
`repro.kernels.int8_gemv.kernel.int8_gemv_call`)."""
