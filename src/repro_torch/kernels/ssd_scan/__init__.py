"""Mamba2 SSD chunked scan on Hopper (port of the Pallas kernel
`repro.kernels.ssd_scan.kernel.ssd_scan_pallas`)."""
