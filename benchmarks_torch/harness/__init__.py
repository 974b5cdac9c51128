"""The benchmark's general code: cell specs, the timed window, the traced
segment and the comparison that decides ``correct``."""
