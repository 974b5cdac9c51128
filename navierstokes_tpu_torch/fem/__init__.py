"""Finite-element core: reference elements, quadrature, the Taylor-Hood
space."""
