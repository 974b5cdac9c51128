"""Operator assembly: host CSR assembly, device formats, band kernels,
element kernels and the mixed operator."""
