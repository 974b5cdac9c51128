"""Plain PyTorch references of the configurations (no import of the
program under test)."""
