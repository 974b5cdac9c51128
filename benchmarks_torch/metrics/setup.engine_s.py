"""``setup.engine_s``: seconds of the program's ``setup.engine`` span in
the run's build: ``FastTaylorHood`` (planar path), or
``PeriodicStructuredTH`` with the ``SpectralOperators`` and
``StructuredConvection`` built on it (spectral path)."""

from harness.spec import load_module


def read(run):
    return load_module("metrics", "program_trace").latest_span("setup.engine")
