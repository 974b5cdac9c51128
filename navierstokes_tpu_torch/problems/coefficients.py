"""Dimensionless numbers -> PDE term coefficients.

Maps (Re, Fr, Ro, Ek) onto the scalar coefficients of the weak-form terms,
with the same conventions and over-constraint rules as the reference
(source/auxiliary_classes.py:167-406):

    convective = 1
    pressure   = 1
    viscous    = 1/Re            (plain)        | Ek/Ro | Ek | 1   (rotating)
    coriolis   = euler = 1/Ro    | 1/(Ek*Re)    | 1
    body force = 1/Fr^2          (None if no Fr given)

Specifying Re, Ro and Ek together is rejected as over-constrained.
"""

from __future__ import annotations

import math

_TERM_KEYS = ("convective_term", "coriolis_term", "euler_term",
              "pressure_term", "viscous_term", "body_force_term")

_NUMBER_ALIASES = {
    "Re": "Reynolds",
    "Fr": "Froude",
    "Ro": "Rossby",
    "Ek": "Ekman",
}


def _validated(value: float) -> float:
    value = float(value)
    if not (math.isfinite(value) and value > 0.0):
        raise ValueError(f"dimensionless number must be positive and finite, "
                         f"got {value}")
    return value


class EquationCoefficientHandler:
    """Holds the dimensionless numbers and derives term coefficients."""

    def __init__(self, **kwargs):
        self._numbers = {}
        for short, long in _NUMBER_ALIASES.items():
            if short in kwargs and long in kwargs:
                raise ValueError(f"specify either {short} or {long}, not both")
            value = kwargs.pop(short, kwargs.pop(long, None))
            if value is not None:
                self._numbers[short] = _validated(value)
        if kwargs:
            raise ValueError(f"unknown dimensionless numbers: {sorted(kwargs)}")
        self._closed = False

    # -- derivation ---------------------------------------------------------
    def _rotation_and_viscous(self):
        """(coriolis/euler coeff, viscous coeff) in the rotating-frame case."""
        n = self._numbers
        if "Ro" in n and "Re" in n:
            return 1.0 / n["Ro"], 1.0 / n["Re"]
        if "Ro" in n and "Ek" in n:
            return 1.0 / n["Ro"], n["Ek"] / n["Ro"]
        if "Ek" in n and "Re" in n:
            return 1.0 / (n["Ek"] * n["Re"]), 1.0 / n["Re"]
        if "Ek" in n:
            return 1.0, n["Ek"]
        if "Ro" in n:
            return 1.0 / n["Ro"], 1.0
        raise RuntimeError("insufficient dimensionless numbers")

    @property
    def equation_coefficients(self) -> dict:
        n = self._numbers
        coeffs = dict.fromkeys(_TERM_KEYS)
        coeffs["convective_term"] = 1.0
        coeffs["pressure_term"] = 1.0
        coeffs["body_force_term"] = (1.0 / n["Fr"] ** 2
                                     if "Fr" in n else None)
        rotating = ("Ro" in n) or ("Ek" in n)
        if rotating:
            if "Re" in n and "Ro" in n and "Ek" in n:
                raise RuntimeError("Overconstrained parameter set.")
            rot, visc = self._rotation_and_viscous()
            coeffs["coriolis_term"] = rot
            coeffs["euler_term"] = rot
            coeffs["viscous_term"] = visc
        else:
            if "Re" not in n:
                raise RuntimeError("a Reynolds number is required")
            coeffs["viscous_term"] = 1.0 / n["Re"]
        return coeffs

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        self._closed = True

    def clear(self) -> None:
        self._closed = False
        self._numbers.clear()

    def modify_dimensionless_number(self, key: str, value: float) -> None:
        """Used by parameter continuation; permitted even when closed."""
        if key not in self._numbers:
            raise KeyError(key)
        self._numbers[key] = _validated(value)

    def get_file_suffix(self) -> str:
        if not self._numbers:
            raise RuntimeError("no dimensionless numbers set")
        return "".join(f"_{key}{value:1.3e}"
                       for key, value in self._numbers.items())

    # -- named accessors ------------------------------------------------------
    def _set_number(self, key: str, value: float,
                    conflicting: tuple) -> None:
        if self._closed:
            raise RuntimeError("coefficient handler is closed")
        if conflicting and all(k in self._numbers for k in conflicting):
            raise RuntimeError("Overconstrained parameter set.")
        self._numbers[key] = _validated(value)

    @property
    def Re(self):
        return self._numbers.get("Re")

    @Re.setter
    def Re(self, value):
        self._set_number("Re", value, ("Ek", "Ro"))

    @property
    def Fr(self):
        return self._numbers.get("Fr")

    @Fr.setter
    def Fr(self, value):
        self._set_number("Fr", value, ())

    @property
    def Ek(self):
        return self._numbers.get("Ek")

    @Ek.setter
    def Ek(self, value):
        self._set_number("Ek", value, ("Re", "Ro"))

    @property
    def Ro(self):
        return self._numbers.get("Ro")

    @Ro.setter
    def Ro(self, value):
        self._set_number("Ro", value, ("Re", "Ek"))

    # -- reporting ------------------------------------------------------------
    def __str__(self) -> str:
        width_l, width_r = 15, 25

        def row(left, right):
            return ("|" + f"{left:^{width_l}}" + "|"
                    + f"{right:^{width_r}}" + "|")

        sep = "+" + width_l * "-" + "+" + width_r * "-" + "+"
        top = "+" + (width_l + width_r + 1) * "-" + "+"
        lines = [top, "|" + f"{'dimensionless numbers':^{width_l + width_r + 1}}" + "|",
                 sep, row("name", "value"), sep]
        for key, value in self._numbers.items():
            lines.append(row(key, f"{value:.3e}"))
        lines.append(sep)
        try:
            coeffs = self.equation_coefficients
        except RuntimeError:
            return "\n".join(lines)
        lines.append("|" + f"{'equation coefficients':^{width_l + width_r + 1}}" + "|")
        lines.extend([sep, row("term", "value"), sep])
        for key, value in coeffs.items():
            name = key.rsplit("_term", 1)[0].replace("_", " ")
            lines.append(row(name, f"{value:.3e}" if value is not None
                             else "None"))
        lines.append(sep)
        return "\n".join(lines)
