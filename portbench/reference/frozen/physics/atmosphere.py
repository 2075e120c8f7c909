# Frozen copy of atm_raytracer_tpu_torch/physics/atmosphere.py (commit 05461a6); the benchmark's reference, not the program.
"""Atmosphere model: piecewise temperature, hydrostatic pressure, n(h, λ).

Re-implements (natively, from physical first principles) the atmosphere half
of the Rust crate ``atm-refraction`` used by the reference:

* config grammar: pressure fixed point, ``first_temperature_function``
  (Linear{gradient} | Spline{boundary_condition, points}), ``next_functions``
  list of {altitude, function}, optional ``temperature_fixed_point``
  (reference README.md:281-323; serde type ``air::AtmosphereDef`` used at
  src/generator/params.rs:453,486);
* queries: ``temperature(h)``, ``pressure(h)``, ``humidity(h)``
  (src/atm_printer.rs:33-44) and refractive index ``n(h)`` at the configured
  wavelength (src/renderer/mod.rs:425);
* the US-76 standard atmosphere default ``AtmosphereDef::us_76``
  (src/generator/params.rs:453).

Physics (documented because the crate source is not vendored; validated by
analytic oracles in tests/test_atmosphere.py):

* Temperature: piecewise functions on altitude intervals split at the
  ``next_functions`` boundaries. Spline segments pin absolute temperatures via
  their (altitude, temperature) points (cubic spline with Natural / Derivatives
  / SecondDerivatives boundary conditions; linear extension outside the point
  range using the end derivatives). Linear segments define only a gradient and
  are anchored by continuity against the nearest anchored segment or the
  ``temperature_fixed_point``.
* Pressure: hydrostatic equilibrium of an ideal gas,
  dP/dh = -(g M / R) P / T(h), integrated from the pressure fixed point.
  Constants: g = 9.80665 m/s², M = 0.0289644 kg/mol, R = 8.31446 J/(mol K).
* Refractivity (optical, wavelength-dependent — README.md:211-214): the
  standard Barrell–Sears-type dispersion formula
      n - 1 = 77.6e-6 (1 + 7.52e-3 / λ_um²) (P_hPa / T)
  (e.g. Bean & Dutton 1966; the common "77.6 K/hPa" optical refractivity with
  Cauchy dispersion). At λ=530 nm, P=101325 Pa, T=288.15 K this gives
  n-1 ≈ 2.80e-4, matching standard air to ~1%.

All host math is float64 numpy; the device consumes compact lookup tables
built by ``physics.ray.RefractionTable.build``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

# Physical constants (CODATA / US Standard Atmosphere 1976).
G0 = 9.80665  # m/s^2
M_AIR = 0.0289644  # kg/mol
R_GAS = 8.31446261815324  # J/(mol K)
GM_OVER_R = G0 * M_AIR / R_GAS  # ~0.034163 K/m

# Refractivity formula constants (see module docstring).
K_REFR = 77.6e-6  # K/hPa
K_DISP = 7.52e-3  # um^2


@dataclasses.dataclass(frozen=True)
class LinearFunction:
    """T(h) = T(anchor) + gradient * (h - anchor); gradient in K/m."""

    gradient: float


@dataclasses.dataclass(frozen=True)
class SplineFunction:
    """Cubic spline through (altitude, temperature) points.

    boundary_condition is one of:
      ("Natural",)                       — zero second derivative at both ends
      ("Derivatives", d_start, d_end)    — clamped first derivatives
      ("SecondDerivatives", s_start, s_end)
    matching the reference YAML grammar (README.md:300-306).
    """

    boundary_condition: Tuple
    points: Tuple[Tuple[float, float], ...]


TempFunction = Union[LinearFunction, SplineFunction]


@dataclasses.dataclass(frozen=True)
class AtmosphereDef:
    """Serde-compatible atmosphere definition (README.md:281-323)."""

    pressure_altitude: float = 0.0
    pressure: float = 101325.0
    first_temperature_function: TempFunction = LinearFunction(-0.0065)
    # list of (boundary_altitude, function); boundaries strictly increasing
    next_functions: Tuple[Tuple[float, TempFunction], ...] = ()
    temperature_fixed_point: Optional[Tuple[float, float]] = None  # (alt, T)
    # relative humidity: a constant, or piecewise-linear (altitude, value)
    # points (clamped outside the range). The crate models humidity(h)
    # (atm_printer.rs:43) but the reference README pins no config grammar
    # for it, so the spec here is ours: `humidity: 0.3` or
    # `humidity: {points: [[alt, value], ...]}`. Does not affect n(h)
    # (PARITY.md — the pinned n formula is humidity-independent).
    humidity: Union[float, Tuple[Tuple[float, float], ...]] = 0.0


def us_76() -> AtmosphereDef:
    """US Standard Atmosphere 1976: seven linear lapse-rate layers.

    Mirrors ``AtmosphereDef::us_76`` (reference src/generator/params.rs:453,486).
    Validated against published US-76 pressure table values in tests.
    """
    return AtmosphereDef(
        pressure_altitude=0.0,
        pressure=101325.0,
        first_temperature_function=LinearFunction(-0.0065),
        next_functions=(
            (11000.0, LinearFunction(0.0)),
            (20000.0, LinearFunction(0.001)),
            (32000.0, LinearFunction(0.0028)),
            (47000.0, LinearFunction(0.0)),
            (51000.0, LinearFunction(-0.0028)),
            (71000.0, LinearFunction(-0.002)),
            (84852.0, LinearFunction(0.0)),
        ),
        temperature_fixed_point=(0.0, 288.15),
    )


# ---------------------------------------------------------------------------
# YAML (de)serialization, schema-compatible with the reference config grammar.
# ---------------------------------------------------------------------------


def _function_from_dict(d) -> TempFunction:
    if not isinstance(d, dict) or len(d) != 1:
        raise ValueError(f"invalid temperature function: {d!r}")
    (kind, body), = d.items()
    if kind == "Linear":
        return LinearFunction(float(body["gradient"]))
    if kind == "Spline":
        bc = body["boundary_condition"]
        if bc == "Natural":
            bc_t = ("Natural",)
        elif isinstance(bc, dict) and "Derivatives" in bc:
            a, b = bc["Derivatives"]
            bc_t = ("Derivatives", float(a), float(b))
        elif isinstance(bc, dict) and "SecondDerivatives" in bc:
            a, b = bc["SecondDerivatives"]
            bc_t = ("SecondDerivatives", float(a), float(b))
        else:
            raise ValueError(f"invalid boundary_condition: {bc!r}")
        points = tuple((float(p[0]), float(p[1])) for p in body["points"])
        return SplineFunction(bc_t, points)
    raise ValueError(f"unknown temperature function kind: {kind!r}")


def atmosphere_def_from_dict(d: Optional[dict]) -> AtmosphereDef:
    """Parse the YAML ``atmosphere:`` block (README.md:281-323)."""
    if d is None:
        return us_76()
    press = d.get("pressure", {"altitude": 0.0, "pressure": 101325.0})
    first = d.get("first_temperature_function")
    first_f = (
        _function_from_dict(first) if first is not None else LinearFunction(-0.0065)
    )
    nexts = []
    for item in d.get("next_functions", []) or []:
        nexts.append((float(item["altitude"]), _function_from_dict(item["function"])))
    nexts.sort(key=lambda t: t[0])
    tfp = d.get("temperature_fixed_point")
    tfp_t = (float(tfp["altitude"]), float(tfp["temperature"])) if tfp else None
    hum = d.get("humidity", 0.0)
    if isinstance(hum, dict):
        pts = tuple(sorted(
            (float(p[0]), float(p[1])) for p in hum["points"]
        ))
        if not pts:
            raise ValueError("humidity.points must be non-empty")
        hum_t: Union[float, Tuple[Tuple[float, float], ...]] = pts
    else:
        hum_t = float(hum)
    return AtmosphereDef(
        pressure_altitude=float(press["altitude"]),
        pressure=float(press["pressure"]),
        first_temperature_function=first_f,
        next_functions=tuple(nexts),
        temperature_fixed_point=tfp_t,
        humidity=hum_t,
    )


# ---------------------------------------------------------------------------
# Spline evaluation
# ---------------------------------------------------------------------------


class _Spline:
    """Cubic spline with the three reference boundary conditions.

    Outside the point range, extends linearly with the end derivatives
    (documented tolerance decision — the crate's extrapolation is unspecified;
    cubic extrapolation would diverge unphysically).
    """

    def __init__(self, fn: SplineFunction):
        from scipy.interpolate import CubicSpline

        xs = np.asarray([p[0] for p in fn.points], dtype=np.float64)
        ys = np.asarray([p[1] for p in fn.points], dtype=np.float64)
        if len(xs) < 2:
            raise ValueError("spline needs at least 2 points")
        if np.any(np.diff(xs) <= 0):
            raise ValueError("spline altitudes must be strictly increasing")
        bc = fn.boundary_condition
        if bc[0] == "Natural":
            bc_type = "natural"
        elif bc[0] == "Derivatives":
            bc_type = ((1, bc[1]), (1, bc[2]))
        elif bc[0] == "SecondDerivatives":
            bc_type = ((2, bc[1]), (2, bc[2]))
        else:
            raise ValueError(f"unknown BC {bc!r}")
        self._cs = CubicSpline(xs, ys, bc_type=bc_type)
        self._x0, self._x1 = xs[0], xs[-1]
        self._y0, self._y1 = ys[0], ys[-1]
        self._d0 = float(self._cs(xs[0], 1))
        self._d1 = float(self._cs(xs[-1], 1))

    def value(self, h):
        h = np.asarray(h, dtype=np.float64)
        inside = self._cs(np.clip(h, self._x0, self._x1))
        below = self._y0 + self._d0 * (h - self._x0)
        above = self._y1 + self._d1 * (h - self._x1)
        return np.where(h < self._x0, below, np.where(h > self._x1, above, inside))

    def derivative(self, h):
        h = np.asarray(h, dtype=np.float64)
        inside = self._cs(np.clip(h, self._x0, self._x1), 1)
        return np.where(
            h < self._x0, self._d0, np.where(h > self._x1, self._d1, inside)
        )


# ---------------------------------------------------------------------------
# Atmosphere
# ---------------------------------------------------------------------------

# Altitude range over which the hydrostatic integral is tabulated (host side).
_H_MIN, _H_MAX, _H_STEP = -5000.0, 90000.0, 0.5


class Atmosphere:
    """Concrete atmosphere built from an :class:`AtmosphereDef`.

    Equivalent of ``Atmosphere::from_def`` + ``temperature/pressure/humidity``
    queries (reference src/atm_printer.rs:33-44) and, with a wavelength, the
    refractive index ``n(h)`` (src/renderer/mod.rs:425).
    """

    def __init__(self, definition: AtmosphereDef,
                 humidity: Optional[float] = None):
        self.definition = definition
        # explicit constructor value overrides the definition's spec
        self._humidity = definition.humidity if humidity is None else float(
            humidity
        )

        # Segment i covers [bounds[i], bounds[i+1]) with function funcs[i].
        boundaries = [alt for alt, _ in definition.next_functions]
        if any(b2 <= b1 for b1, b2 in zip(boundaries, boundaries[1:])):
            raise ValueError("next_functions altitudes must be increasing")
        self._bounds = np.asarray([-np.inf] + boundaries + [np.inf])
        funcs: List[TempFunction] = [definition.first_temperature_function] + [
            f for _, f in definition.next_functions
        ]
        self._splines = {
            i: _Spline(f) for i, f in enumerate(funcs) if isinstance(f, SplineFunction)
        }
        self._funcs = funcs
        self._anchor_segments()
        self._build_pressure_table()

    # -- temperature ------------------------------------------------------

    def _segment_index(self, h: np.ndarray) -> np.ndarray:
        # searchsorted over interior boundaries: segment i for bounds[i]<=h<bounds[i+1]
        return np.searchsorted(self._bounds[1:-1], h, side="right")

    def _anchor_segments(self) -> None:
        """Resolve the absolute temperature offset of every linear segment.

        Spline segments are self-anchored by their points. Linear segments are
        anchored by (a) the ``temperature_fixed_point`` if it falls inside
        them, else (b) continuity with the nearest anchored neighbor,
        propagated outward. Mirrors the reference grammar note: with only
        Linear functions a fixed point is mandatory (README.md:318-323).
        """
        n = len(self._funcs)
        # value of T at segment-local anchor altitude: (anchor_h, anchor_T)
        anchors: List[Optional[Tuple[float, float]]] = [None] * n

        fp = self.definition.temperature_fixed_point
        if fp is not None:
            i = int(self._segment_index(np.asarray(fp[0])))
            anchors[i] = (fp[0], fp[1])

        for i in self._splines:
            # spline segments: anchor irrelevant, flagged by presence in _splines
            anchors[i] = ("spline", 0.0)  # type: ignore[assignment]

        if all(a is None for a in anchors):
            raise ValueError(
                "atmosphere has only Linear temperature functions and no "
                "temperature_fixed_point (README.md:318-323)"
            )

        # Propagate outward (left-to-right then right-to-left) via continuity
        # at the finite boundaries between segments.
        def seg_value_at(i: int, h: float) -> float:
            if i in self._splines:
                return float(self._splines[i].value(h))
            a_h, a_t = anchors[i]  # type: ignore[misc]
            g = self._funcs[i].gradient  # type: ignore[union-attr]
            return a_t + g * (h - a_h)

        changed = True
        while changed:
            changed = False
            for i in range(n):
                if anchors[i] is not None:
                    continue
                # left neighbor anchored? boundary between i-1 and i is bounds[i]
                if i > 0 and anchors[i - 1] is not None:
                    b = float(self._bounds[i])
                    anchors[i] = (b, seg_value_at(i - 1, b))
                    changed = True
                elif i + 1 < n and anchors[i + 1] is not None:
                    b = float(self._bounds[i + 1])
                    anchors[i] = (b, seg_value_at(i + 1, b))
                    changed = True
        self._anchors = anchors

    def temperature(self, h) -> np.ndarray:
        """T(h) in Kelvin (vectorized, float64)."""
        h = np.asarray(h, dtype=np.float64)
        seg = self._segment_index(h)
        out = np.empty_like(h)
        for i in range(len(self._funcs)):
            m = seg == i
            if not np.any(m):
                continue
            if i in self._splines:
                out[m] = self._splines[i].value(h[m])
            else:
                a_h, a_t = self._anchors[i]
                out[m] = a_t + self._funcs[i].gradient * (h[m] - a_h)
        return out

    def temperature_gradient(self, h) -> np.ndarray:
        """dT/dh in K/m (vectorized, float64)."""
        h = np.asarray(h, dtype=np.float64)
        seg = self._segment_index(h)
        out = np.empty_like(h)
        for i in range(len(self._funcs)):
            m = seg == i
            if not np.any(m):
                continue
            if i in self._splines:
                out[m] = self._splines[i].derivative(h[m])
            else:
                out[m] = self._funcs[i].gradient
        return out

    # -- pressure ----------------------------------------------------------

    def _build_pressure_table(self) -> None:
        """Tabulate ln P on a dense grid by hydrostatic integration.

        ln P(h) = ln P0 - (gM/R) ∫_{h0}^{h} dh'/T(h'), trapezoid on a 0.5 m
        grid in float64 (relative error ≲1e-12 for smooth T).
        """
        hs = np.arange(_H_MIN, _H_MAX + _H_STEP, _H_STEP, dtype=np.float64)
        inv_t = 1.0 / self.temperature(hs)
        # cumulative trapezoid of 1/T from grid start
        cum = np.concatenate(
            [[0.0], np.cumsum((inv_t[1:] + inv_t[:-1]) * 0.5 * _H_STEP)]
        )
        h0 = self.definition.pressure_altitude
        # integral from h0 to h = cum(h) - cum(h0), cum(h0) by interpolation
        cum_h0 = np.interp(h0, hs, cum)
        self._grid_h = hs
        self._grid_lnp = np.log(self.definition.pressure) - GM_OVER_R * (cum - cum_h0)

    def pressure(self, h) -> np.ndarray:
        """P(h) in Pa (vectorized, float64)."""
        h = np.asarray(h, dtype=np.float64)
        return np.exp(np.interp(h, self._grid_h, self._grid_lnp))

    def humidity(self, h) -> np.ndarray:
        """Relative humidity at altitude h (atm_printer.rs:43).

        Constant (default 0) or piecewise-linear in altitude from the
        config's ``humidity: {points: ...}`` spec, clamped outside the
        point range. Does not affect n(h) — the pinned refractivity
        formula is humidity-independent (PARITY.md).
        """
        h = np.asarray(h, dtype=np.float64)
        if isinstance(self._humidity, tuple):
            alts = np.asarray([p[0] for p in self._humidity])
            vals = np.asarray([p[1] for p in self._humidity])
            return np.interp(h, alts, vals)
        return np.full_like(h, self._humidity)

    # -- refractive index ---------------------------------------------------

    def n(self, h, wavelength: float = 530e-9) -> np.ndarray:
        """Refractive index of air at altitude h for the given wavelength [m].

        Reference call: ``env.n(alt)`` (src/renderer/mod.rs:425); wavelength
        default 530 nm (src/generator/params.rs:477-479).
        """
        lam_um = wavelength * 1e6
        c = K_REFR * (1.0 + K_DISP / (lam_um * lam_um)) / 100.0  # per (Pa/K)
        return 1.0 + c * self.pressure(h) / self.temperature(h)

    def dn_dh(self, h, wavelength: float = 530e-9) -> np.ndarray:
        """Analytic dn/dh: (n-1) * (-(gM/R) - dT/dh) / T."""
        lam_um = wavelength * 1e6
        c = K_REFR * (1.0 + K_DISP / (lam_um * lam_um)) / 100.0
        t = self.temperature(h)
        n_minus_1 = c * self.pressure(h) / t
        return n_minus_1 * (-(GM_OVER_R) - self.temperature_gradient(h)) / t

    def dlnn_dh(self, h, wavelength: float = 530e-9) -> np.ndarray:
        """d(ln n)/dh — the quantity the ray ODE consumes."""
        return self.dn_dh(h, wavelength) / self.n(h, wavelength)
