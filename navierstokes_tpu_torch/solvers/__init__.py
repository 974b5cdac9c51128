"""Time-step solvers.  Ported so far: the planar projection step."""
