"""Multi-device layer.  Only the host-side scatter table is ported so far."""
