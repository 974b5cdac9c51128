"""Finite-element core: reference elements, quadrature, the Taylor-Hood
space, boundary-condition types and their compilation."""
