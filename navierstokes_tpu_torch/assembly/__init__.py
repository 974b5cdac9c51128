"""Operator assembly: host CSR assembly, device formats, band kernels."""
