"""Earth models: geometry services for the 8 reference variants (PyTorch).

Counterpart of ``atm_raytracer_tpu/models/earth.py`` (reference
src/utils/earth_model/mod.rs:19-145 and directional_calc.rs). Host parts
(config parsing, canonical aliases, the physics shape) are plain Python;
the device parts work on float32 tensors on any device:

* ``geodesic_delta`` — (dlat, dlon) degrees from the observer along an
  azimuth, in the cancellation-free delta forms (great circle, Vincenty
  direct, azimuthal-equidistant line, lat-scaled flat), ~cm over 200 km;
* ``world_directions`` — the local (north, east, up) basis;
* ``normal_offsets`` — degree offsets of a NORMAL_DIFF-meter move.

``coords_at_dist_host`` is the float64 geodesic (absolute lat/lon), the
oracle of those delta forms; it and ``as_cartesian`` run in numpy on numpy
inputs and in torch on the device of tensor inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..physics.ray import FLAT, EarthShape, _f32

DEGREE_DISTANCE = 10_000_000.0 / 90.0  # flat-model meters per degree (mod.rs:12)
EARTH_R = 6_371_000.0
WGS84_A = 6_378_137.0
WGS84_B = 6_356_752.314245

# Central-difference arm for terrain normals (utils.rs:16).
NORMAL_DIFF = 15.0

_FLAT_KINDS = ("AzimuthalEquidistant", "FlatDistorted", "ObserverAe",
               "SimpleObserverAe")


@dataclasses.dataclass(frozen=True)
class EarthModel:
    """One of the 8 reference variants (mod.rs:19-28).

    kind: SimpleSphere | Spherical | Ellipsoid | Wgs84 | AzimuthalEquidistant
          | FlatDistorted | ObserverAe | SimpleObserverAe
    """

    kind: str
    radius: Optional[float] = None  # Spherical / ObserverAe (proj_radius)
    a: Optional[float] = None  # Ellipsoid
    b: Optional[float] = None

    @staticmethod
    def from_config(value) -> "EarthModel":
        """Parse the YAML ``earth_shape`` value (README.md:181-209)."""
        if isinstance(value, str):
            if value in ("SimpleSphere", "AzimuthalEquidistant", "FlatDistorted",
                         "SimpleObserverAe", "Wgs84"):
                return EarthModel(kind=value)
            raise ValueError(f"unknown earth_shape {value!r}")
        if isinstance(value, dict) and len(value) == 1:
            (kind, body), = value.items()
            if kind == "Spherical":
                return EarthModel(kind="Spherical", radius=float(body["radius"]))
            if kind == "ObserverAe":
                # serde spells it proj_radius (mod.rs:26); the README
                # documents projection_radius (README.md:189): accept both
                key = "proj_radius" if "proj_radius" in body else "projection_radius"
                return EarthModel(kind="ObserverAe", radius=float(body[key]))
            if kind == "Ellipsoid":
                return EarthModel(kind="Ellipsoid", a=float(body["a"]),
                                  b=float(body["b"]))
        raise ValueError(f"invalid earth_shape config: {value!r}")

    def to_config(self):
        """The YAML value ``from_config`` reads; ObserverAe in the reference
        binary's serde spelling ``proj_radius`` (mod.rs:26)."""
        if self.kind == "Spherical":
            return {"Spherical": {"radius": self.radius}}
        if self.kind == "ObserverAe":
            return {"ObserverAe": {"proj_radius": self.radius}}
        if self.kind == "Ellipsoid":
            return {"Ellipsoid": {"a": self.a, "b": self.b}}
        return self.kind

    def _canonical(self) -> "EarthModel":
        """Resolve the Simple*/Wgs84 aliases (mod.rs:64-71,97-103,132-143)."""
        if self.kind == "SimpleSphere":
            return EarthModel(kind="Spherical", radius=EARTH_R)
        if self.kind == "SimpleObserverAe":
            return EarthModel(kind="ObserverAe", radius=EARTH_R)
        if self.kind == "Wgs84":
            return EarthModel(kind="Ellipsoid", a=WGS84_A, b=WGS84_B)
        return self

    @property
    def is_flat_family(self) -> bool:
        return self.kind in _FLAT_KINDS

    def to_shape(self) -> EarthShape:
        """Physics shape (mod.rs:95-112): ellipsoid → sphere of (2a+b)/3."""
        m = self._canonical()
        if m.kind == "Spherical":
            return EarthShape(m.radius)
        if m.kind == "Ellipsoid":
            return EarthShape((2.0 * m.a + m.b) / 3.0)
        return FLAT

    def distance_radius(self) -> Optional[float]:
        """Radius of geodesic distances; ObserverAe measures distances on
        its projection sphere though its physics shape is Flat
        (mod.rs:127-130)."""
        m = self._canonical()
        if m.kind in ("Spherical", "ObserverAe"):
            return m.radius
        return None

    def world_directions(self, lat, lon):
        """(north, east, up) unit vectors at (lat, lon) degrees (mod.rs:31-57).

        numpy inputs give host f64 vectors; tensors give vectors on their
        device. Flat family: AE-plane directions (north toward the pole).
        Each result has shape lat.shape + (3,).
        """
        if isinstance(lat, torch.Tensor):
            xp, stack = torch, lambda xs: torch.stack(xs, dim=-1)
        else:
            lat, lon = np.asarray(lat), np.asarray(lon)
            xp, stack = np, lambda xs: np.stack(xs, axis=-1)
        lon_r = xp.deg2rad(lon)
        sinlon, coslon = xp.sin(lon_r), xp.cos(lon_r)
        zero = xp.zeros_like(sinlon)
        if self.is_flat_family:
            one = xp.ones_like(sinlon)
            north = stack([-coslon, -sinlon, zero])
            east = stack([-sinlon, coslon, zero])
            up = stack([zero, zero, one])
            return north, east, up
        lat_r = xp.deg2rad(lat)
        sinlat, coslat = xp.sin(lat_r), xp.cos(lat_r)
        up = stack([coslat * coslon, coslat * sinlon, sinlat])
        north = stack([-sinlat * coslon, -sinlat * sinlon, coslat])
        east = stack([-sinlon, coslon, zero])
        return north, east, up

    def as_cartesian(self, lat, lon, elev):
        """Geodetic → global cartesian in float64 (mod.rs:59-93): numpy in,
        numpy out; a tensor among the inputs gives a float64 tensor on its
        device."""
        m = self._canonical()
        xp, f64 = _namespace(lat, lon, elev)
        lat, lon, elev = f64(lat), f64(lon), f64(elev)
        if m.kind == "Spherical":
            r = m.radius + elev
            la, lo = xp.deg2rad(lat), xp.deg2rad(lon)
            return xp.stack(
                [r * xp.cos(la) * xp.cos(lo), r * xp.cos(la) * xp.sin(lo),
                 r * xp.sin(la)], axis=-1)
        if m.kind == "Ellipsoid":
            a, b = m.a, m.b
            e2 = 1.0 - (b * b) / (a * a)
            la, lo = xp.deg2rad(lat), xp.deg2rad(lon)
            n = a / xp.sqrt(1.0 - e2 * xp.sin(la) ** 2)
            return xp.stack(
                [(n + elev) * xp.cos(la) * xp.cos(lo),
                 (n + elev) * xp.cos(la) * xp.sin(lo),
                 (n * (1.0 - e2) + elev) * xp.sin(la)], axis=-1)
        # flat family: azimuthal-equidistant plane (mod.rs:82-91)
        r = (90.0 - lat) * DEGREE_DISTANCE
        lo = xp.deg2rad(lon)
        return xp.stack([r * xp.cos(lo), r * xp.sin(lo), elev], axis=-1)

    def coords_at_dist_host(self, lat0: float, lon0: float, az_deg, dist):
        """(lat, lon) degrees at ``dist`` meters along an azimuth, float64
        and vectorized (directional_calc.rs): the oracle of the device
        delta forms, the walk of ``output-elev-profile`` and the objects'
        column scan. Numpy in, numpy out; a tensor among ``az_deg`` and
        ``dist`` gives float64 tensors on its device."""
        m = self._canonical()
        xp, f64 = _namespace(az_deg, dist)
        az = xp.deg2rad(f64(az_deg))
        dist = f64(dist)
        if m.kind == "FlatDistorted":  # directional_calc.rs:41-48
            dlat = xp.cos(az) * dist / DEGREE_DISTANCE
            dlon = xp.sin(az) * dist / DEGREE_DISTANCE / float(np.cos(np.deg2rad(lat0)))
            return lat0 + dlat, lon0 + dlon
        if m.kind == "AzimuthalEquidistant":  # directional_calc.rs:20-28
            pos = f64(self.as_cartesian(lat0, lon0, 0.0))
            north, east, _ = (f64(v) for v in self.world_directions(lat0, lon0))
            dir_v = north * xp.cos(az)[..., None] + east * xp.sin(az)[..., None]
            p2 = pos + dir_v * dist[..., None]
            lon = xp.rad2deg(xp.arctan2(p2[..., 1], p2[..., 0]))
            r = xp.hypot(p2[..., 0], p2[..., 1])
            return 90.0 - r / DEGREE_DISTANCE, lon
        if m.kind in ("Spherical", "ObserverAe"):  # directional_calc.rs:71-86
            # the spherical basis even for ObserverAe, whose calculator is
            # the spherical one
            la, lo = np.deg2rad(lat0), np.deg2rad(lon0)
            pos = f64([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)])
            dirn = f64([-np.sin(la) * np.cos(lo), -np.sin(la) * np.sin(lo), np.cos(la)])
            dire = f64([-np.sin(lo), np.cos(lo), 0.0])
            d = dirn * xp.cos(az)[..., None] + dire * xp.sin(az)[..., None]
            ang = dist / m.radius
            f = pos * xp.cos(ang)[..., None] + d * xp.sin(ang)[..., None]
            return (xp.rad2deg(xp.arcsin(f[..., 2])),
                    xp.rad2deg(xp.arctan2(f[..., 1], f[..., 0])))
        return _vincenty_direct(m.a, m.b, lat0, lon0, az, dist)

    def geodesic_delta(self, lat0: float, lon0: float, az_deg: torch.Tensor,
                       dist: torch.Tensor):
        """Device geodesic: (dlat, dlon) degrees from the observer, float32.

        ``az_deg`` and ``dist`` are tensors on one device that broadcast
        together; ``lat0``/``lon0`` are host floats.
        """
        m = self._canonical()
        az = torch.deg2rad(az_deg.to(torch.float32))
        dist = dist.to(torch.float32)
        if m.kind == "FlatDistorted":  # directional_calc.rs:41-48
            dlat = torch.cos(az) * dist / DEGREE_DISTANCE
            dlon = (torch.sin(az) * dist / DEGREE_DISTANCE
                    / _f32(np.cos(np.deg2rad(lat0))))
            return dlat, dlon
        if m.kind == "AzimuthalEquidistant":  # directional_calc.rs:20-28
            # pos = (r0, 0) in a frame rotated so lon0 = 0;
            # north = −radial, east = +tangential
            r0 = _f32((90.0 - lat0) * DEGREE_DISTANCE)
            dxr = -torch.cos(az) * dist
            dxt = torch.sin(az) * dist
            r2 = torch.sqrt((r0 + dxr) ** 2 + dxt ** 2)
            # r2² − r0² = 2 r0 dxr + dxr² + dxt², cancellation-free
            dr = (2.0 * r0 * dxr + dxr * dxr + dxt * dxt) / (r2 + r0)
            dlat = -dr / DEGREE_DISTANCE
            dlon = torch.rad2deg(torch.atan2(dxt, r0 + dxr))
            return dlat, dlon
        if m.kind in ("Spherical", "ObserverAe"):
            return _sphere_delta_device(m.radius, lat0, az, dist)
        return _vincenty_delta_device(m.a, m.b, lat0, az, dist)

    def normal_offsets(self, lat: torch.Tensor):
        """(dlat_north, dlon_east) degrees for a NORMAL_DIFF-meter move, the
        small-displacement forms of utils.rs:15-27 (error ~3.5e-5 m)."""
        m = self._canonical()
        lat_r = torch.deg2rad(lat)
        d = NORMAL_DIFF
        if m.kind == "FlatDistorted":
            dlat = d / DEGREE_DISTANCE + torch.zeros_like(lat)
            dlon = d / DEGREE_DISTANCE / torch.cos(lat_r)
            return dlat, dlon
        if m.kind == "AzimuthalEquidistant":
            r = (90.0 - lat) * DEGREE_DISTANCE
            dlat = d / DEGREE_DISTANCE + torch.zeros_like(lat)
            dlon = torch.rad2deg(d / r)
            return dlat, dlon
        if m.kind in ("Spherical", "ObserverAe"):
            # float32 degrees of the float32 angle, as a device rad2deg gives
            step_deg = _f32(np.float32(d / m.radius) * np.float32(180.0 / math.pi))
            dlat = step_deg + torch.zeros_like(lat)
            dlon = step_deg / torch.cos(lat_r)
            return dlat, dlon
        # Ellipsoid: meridian / prime-vertical curvature radii
        a, b = m.a, m.b
        e2 = 1.0 - (b * b) / (a * a)
        s2 = torch.sin(lat_r) ** 2
        mrad = a * (1.0 - e2) / (1.0 - e2 * s2) ** 1.5
        nrad = a / torch.sqrt(1.0 - e2 * s2)
        return torch.rad2deg(d / mrad), torch.rad2deg(d / (nrad * torch.cos(lat_r)))

    def enu_rel(self, dlat_p, dlon_p, elev_p, dlat_o, dlon_o, elev_o, lat0: float):
        """as_cartesian(P) − as_cartesian(O) in O's (east, north, up), [..., 3].

        Lat/lon arguments are observer-relative degrees, float32 tensors on
        one device that broadcast together; ``lat0`` is the observer's
        absolute latitude. Exact up to O(d³/R²) for separations d:
        mm-accurate inside culling radii.

        Spherical family: the exact global difference rotated into O's ENU
        basis. Flat family: the AE-plane difference (mod.rs:82-91) in O's
        (east, north, up) = (tangential, −radial, z). Ellipsoid: the
        spherical formula on the local sphere of radius (2a+b)/3.
        """
        terms = self.enu_terms(dlat_p, dlon_p, dlat_o, dlon_o, lat0)
        return self.enu_from_terms(terms, elev_p, elev_o)

    def enu_radius(self) -> Optional[float]:
        """The sphere radius of ``enu_rel``; None for the flat family."""
        m = self._canonical()
        if m.is_flat_family:
            return None
        return (2.0 * m.a + m.b) / 3.0 if m.kind == "Ellipsoid" else m.radius

    def enu_terms(self, dlat_p, dlon_p, dlat_o, dlon_o, lat0: float) -> tuple:
        """The three terms of ``enu_rel`` that do not depend on P's
        altitude. Spherical family: P's unit radial in O's ENU as (u_e,
        u_n, u_u − 1); flat family: (east, north, 0), which no altitude
        moves. ``enu_from_terms`` finishes the vector at any altitude."""
        if self.is_flat_family:
            # north = −(r_p cosΔλ − r_o), cancellation-free:
            #       = −dr + (r_o + dr)·2sin²(Δλ/2)
            r_o = (90.0 - (lat0 + dlat_o)) * DEGREE_DISTANCE
            dr = -(dlat_p - dlat_o) * DEGREE_DISTANCE
            dlon_r = torch.deg2rad(dlon_p - dlon_o)
            r_p = r_o + dr
            east = r_p * torch.sin(dlon_r)
            north = -dr + r_p * 2.0 * torch.sin(dlon_r * 0.5) ** 2
            return east, north, torch.zeros_like(east)
        lo = torch.deg2rad(lat0 + dlat_o)
        sin_o, cos_o = torch.sin(lo), torch.cos(lo)
        dlat_r = torch.deg2rad(dlat_p - dlat_o)
        dlon_r = torch.deg2rad(dlon_p - dlon_o)
        cos_p = torch.cos(torch.deg2rad(lat0 + dlat_p))
        # unit radial of P in O's ENU, small-quantity forms
        two_s2_lon = 2.0 * torch.sin(dlon_r * 0.5) ** 2  # = 1 − cos Δλ
        u_e = cos_p * torch.sin(dlon_r)
        u_n = torch.sin(dlat_r) + cos_p * sin_o * two_s2_lon
        u_u_m1 = -2.0 * torch.sin(dlat_r * 0.5) ** 2 - cos_p * cos_o * two_s2_lon
        return u_e, u_n, u_u_m1

    def enu_from_terms(self, terms: tuple, elev_p, elev_o) -> torch.Tensor:
        """``enu_rel`` [..., 3] from its ``enu_terms`` at P's altitude
        ``elev_p``: affine in it, r_p = R + elev_p scaling the unit radial
        (the flat family's east and north do not move)."""
        radius = self.enu_radius()
        if radius is None:
            east, north, _ = terms
            up = elev_p - elev_o
        else:
            u_e, u_n, u_u_m1 = terms
            r_p = radius + elev_p
            east = r_p * u_e
            north = r_p * u_n
            up = (elev_p - elev_o) + r_p * u_u_m1
        return torch.stack(torch.broadcast_tensors(east, north, up), dim=-1)


def _sphere_delta_device(radius, lat0, az, dist):
    """Great-circle rotation in cancellation-free delta form, f32.

    With z = sin(lat) and σ = dist/R, the rotated point has
    z' = z0 cos σ + cos(lat0) sin σ cos az; using 1 − cos σ = 2 sin²(σ/2),
      Δz = −2 z0 sin²(σ/2) + c0 sin σ cos az,
      sin(dlat) = c0 Δz + z0 c0 ε / (1 + √(1−ε)),  ε = (2 z0 + Δz) Δz / c0²,
      tan(dlon) = sin σ sin az / (c0 cos σ − z0 sin σ cos az).
    """
    la0 = np.deg2rad(np.float64(lat0))
    z0 = _f32(np.sin(la0))
    c0 = _f32(np.cos(la0))
    sigma = dist / _f32(radius)
    sin_s = torch.sin(sigma)
    two_s2 = 2.0 * torch.sin(sigma * 0.5) ** 2  # = 1 − cos σ
    cos_az = torch.cos(az)
    sin_az = torch.sin(az)

    dz = -z0 * two_s2 + c0 * sin_s * cos_az
    eps = (2.0 * z0 + dz) * dz / _f32(np.float32(c0) * np.float32(c0))
    eps = eps.clamp(min=-1.0)  # near the poles c0 → 0
    sin_dlat = c0 * dz + z0 * c0 * eps / (1.0 + torch.sqrt((1.0 - eps).clamp(min=0.0)))
    dlat = torch.rad2deg(torch.asin(sin_dlat.clamp(-1.0, 1.0)))

    e_comp = sin_s * sin_az
    denom = c0 * (1.0 - two_s2) - z0 * sin_s * cos_az
    dlon = torch.rad2deg(torch.atan2(e_comp, denom))
    return dlat, dlon


def _vincenty_delta_device(a, b, lat0, az, dist, iters: int = 12):
    """Vincenty direct (directional_calc.rs:103-185) in cancellation-free
    (dlat, dlon) delta form, f32: dφ = dU + δ(U₂) − δ(U₁) with
    δ(U) = atan(f sinU cosU / (1 − f cos²U)), dU from the auxiliary-sphere
    rotation (the ``_sphere_delta_device`` algebra), dlon = Vincenty's L."""
    f = (a - b) / a
    u1 = float(np.arctan((1.0 - f) * np.tan(np.deg2rad(np.float64(lat0)))))
    z0 = _f32(np.sin(u1))
    c0 = _f32(np.cos(u1))
    tan_u1 = _f32(np.tan(u1))
    delta1 = _f32(np.arctan(f * np.sin(u1) * np.cos(u1) / (1.0 - f * np.cos(u1) ** 2)))
    ff = _f32(f)

    cos_az = torch.cos(az)
    sin_az = torch.sin(az)
    sig1 = torch.atan2(torch.full_like(cos_az, tan_u1), cos_az)
    sin_alfa = c0 * sin_az
    cos2 = 1.0 - sin_alfa ** 2
    u2c = cos2 * _f32((a * a - b * b) / (b * b))
    cap_a = 1.0 + u2c / 256.0 * (64.0 + u2c * (-12.0 + 5.0 * u2c))
    cap_b = u2c / 512.0 * (128.0 + u2c * (-64.0 + 37.0 * u2c))
    cap_c = _f32(f / 16.0) * cos2 * (4.0 + ff * (4.0 - 3.0 * cos2))

    base = dist / _f32(b) / cap_a
    sig = base
    for _ in range(iters):
        sigm = 2.0 * sig1 + sig
        dsig = cap_b * torch.sin(sig) * (
            torch.cos(sigm)
            + cap_b / 4.0 * torch.cos(sig) * (-1.0 + 2.0 * torch.cos(sigm) ** 2)
        )
        sig = base + dsig

    sin_s = torch.sin(sig)
    cos_s = torch.cos(sig)
    two_s2 = 2.0 * torch.sin(sig * 0.5) ** 2  # = 1 − cos σ
    dz = -z0 * two_s2 + c0 * sin_s * cos_az
    eps = (2.0 * z0 + dz) * dz / _f32(np.float32(c0) * np.float32(c0))
    eps = eps.clamp(min=-1.0)
    sin_du = c0 * dz + z0 * c0 * eps / (1.0 + torch.sqrt((1.0 - eps).clamp(min=0.0)))
    du = torch.asin(sin_du.clamp(-1.0, 1.0))
    u2_abs = _f32(u1) + du
    delta2 = torch.atan(
        ff * torch.sin(u2_abs) * torch.cos(u2_abs)
        / (1.0 - ff * torch.cos(u2_abs) ** 2)
    )
    dlat = du + (delta2 - delta1)

    sigm = 2.0 * sig1 + sig
    lam = torch.atan(sin_s * sin_az / (c0 * cos_s - z0 * sin_s * cos_az))
    dl = lam - (1.0 - cap_c) * ff * sin_alfa * (
        sig
        + cap_c * sin_s * (
            torch.cos(sigm) + cap_c * cos_s * (-1.0 + 2.0 * torch.cos(sigm) ** 2)
        )
    )
    return torch.rad2deg(dlat), torch.rad2deg(dl)


def _vincenty_direct(a, b, lat0, lon0, az_rad, dist, iters: int = 12):
    """Vincenty direct problem in float64 (directional_calc.rs:103-185), in
    the namespace of ``az_rad`` and ``dist`` (``_namespace``). The
    reference iterates to 1e-10; a fixed count converges in 3-4."""
    xp, f64 = _namespace(az_rad, dist)
    f = (a - b) / a
    red_lat = np.arctan((1.0 - f) * np.tan(np.deg2rad(np.float64(lat0))))
    sr, cr = float(np.sin(red_lat)), float(np.cos(red_lat))
    sig1 = xp.arctan2(f64(np.tan(red_lat)), xp.cos(az_rad))
    alfa = xp.arcsin(cr * xp.sin(az_rad))
    cos2 = xp.cos(alfa) ** 2
    u2 = cos2 * (a * a - b * b) / (b * b)
    cap_a = 1.0 + u2 / 256.0 * (64.0 + u2 * (-12.0 + 5.0 * u2))
    cap_b = u2 / 512.0 * (128.0 + u2 * (-64.0 + 37.0 * u2))
    cap_c = f / 16.0 * cos2 * (4.0 + f * (4.0 - 3.0 * cos2))

    base = dist / b / cap_a
    sig = base
    for _ in range(iters):
        sigm = 2.0 * sig1 + sig
        dsig = cap_b * xp.sin(sig) * (
            xp.cos(sigm) + cap_b / 4.0 * xp.cos(sig) * (-1.0 + 2.0 * xp.cos(sigm) ** 2)
        )
        sig = base + dsig

    sigm = 2.0 * sig1 + sig
    ss, cs = xp.sin(sig), xp.cos(sig)
    ca1 = xp.cos(az_rad)
    lat2 = xp.arctan(
        (sr * cs + cr * ss * ca1)
        / ((1.0 - f) * xp.sqrt(xp.sin(alfa) ** 2 + (sr * ss - cr * cs * ca1) ** 2))
    )
    lam = xp.arctan(ss * xp.sin(az_rad) / (cr * cs - sr * ss * ca1))
    dl = lam - (1.0 - cap_c) * f * xp.sin(alfa) * (
        sig + cap_c * ss * (xp.cos(sigm) + cap_c * cs * (-1.0 + 2.0 * xp.cos(sigm) ** 2))
    )
    return xp.rad2deg(lat2), lon0 + xp.rad2deg(dl)


def _namespace(*xs):
    """(namespace, float64 converter) for the float64 geodesy: torch and
    tensors on the device of the first tensor among ``xs``, else numpy
    (``world_directions``' rule)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            dev = x.device
            return torch, lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    return np, lambda a: np.asarray(a, np.float64)
