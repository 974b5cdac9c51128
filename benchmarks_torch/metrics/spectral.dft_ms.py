"""``spectral.dft_ms``: ms per step of the phase ``spectral.dft``, the
spectral step's ``MatmulDFT`` transforms (the forward one in
``convection``, the inverse one in ``correction``;
``ChunkLoop.phase_ms()``)."""

from harness.spec import load_module


def read(run):
    return load_module("metrics", "program_trace").phase_ms(run,
                                                            "spectral.dft")
