"""``setup.amg_s``: seconds of the program's ``setup.amg`` span in the run's
build: ``linalg/amg.AMG``'s construction of the hierarchy (host SciPy
aggregation and Galerkin products, upload)."""

from harness.spec import load_module


def read(run):
    return load_module("metrics", "program_trace").latest_span("setup.amg")
