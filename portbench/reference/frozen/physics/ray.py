# Frozen copy of atm_raytracer_tpu_torch/physics/ray.py (commit 05461a6); the benchmark's reference, not the program.
"""Batched fixed-step ray marching of the atmospheric-refraction ODE (PyTorch).

Counterpart of ``atm_raytracer_tpu/physics/ray.py``; the ODE, coordinates,
initial conditions and path-length rule are documented there:

* flat:      h'' = l(h) (1 + h'^2),                    h'(0) = tan(e)
* spherical: h'' = l(h) (u^2 + h'^2) + (u^2 + 2 h'^2)/(u R),  u = 1 + h/R,
             h'(0) = (1 + h0/R) tan(e)

with l(h) = d(ln n)/dh from a host-built f64 table (``RefractionTable``).

All rays march in lockstep: ``march_rays`` runs the plain PyTorch path
(``march_nodes_plain``, ``hermite_fill``, ``_finish_march``) on the device
of its inputs.

The per-pixel Rectilinear generator marches through the fused scans
``march_scan_light`` and ``march_scan``: Python loops over coarse windows
that hand each window to a consumer, so the [..., N] altitude grid never
exists. They run as PyTorch ops on any device: the tilt-0 scan and the
culled tilted path's capture scan.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .atmosphere import Atmosphere

DEATH_ALTITUDE = -1000.0  # path-death rule threshold (utils.rs:167)
CHEB_DEG = 6


@dataclasses.dataclass(frozen=True)
class EarthShape:
    """Physics shape: flat (radius None) or sphere (mod.rs:95-112)."""

    radius: Optional[float]

    @property
    def is_flat(self) -> bool:
        return self.radius is None


FLAT = EarthShape(None)


@dataclasses.dataclass
class RefractionTable:
    """Uniform-grid table of l(h) on one device (f32), plus the piecewise
    Chebyshev fit ``poly`` (host tuples) when the profile admits one.

    A sweep's per-frame tables stack (``stack``) into values [F, n] and
    pairs [F, n-1, 2] with no fit: ray b of a march then reads the table of
    frame b // rays_per_frame."""

    h0: float  # f32-representable
    inv_dh: float
    values: torch.Tensor  # [n] f32, or [F, n] stacked
    pairs: torch.Tensor  # [n-1, 2] f32: (values[i], values[i+1]); [F, n-1, 2] stacked
    poly: Optional[Tuple] = None  # ((h_lo, h_hi, (c0..c6)), ...)
    # poly_rows by device, built on first use (callers must not write to them)
    _rows: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                    compare=False)
    # host-side data derived once: the values on the host ("values", set by
    # from_values)
    _host: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                    compare=False)

    @staticmethod
    def build(atm: Atmosphere, wavelength: float, h_lo: float = -2000.0,
              h_hi: float = 20000.0, dh: float = 1.0, *, device) -> "RefractionTable":
        hs = np.arange(h_lo, h_hi + dh, dh, dtype=np.float64)
        vals64 = atm.dlnn_dh(hs, wavelength)
        return RefractionTable.from_values(
            vals64.astype(np.float32), h_lo, 1.0 / dh,
            _fit_piecewise_cheb(vals64, h_lo, dh), device,
        )

    @staticmethod
    def from_values(values: np.ndarray, h0: float, inv_dh: float, poly,
                    device) -> "RefractionTable":
        vals = np.asarray(values, np.float32)
        pairs = np.stack([vals[:-1], vals[1:]], axis=-1)
        table = RefractionTable(
            h0=float(np.float32(h0)),
            inv_dh=float(np.float32(inv_dh)),
            values=torch.tensor(vals, device=device),
            pairs=torch.tensor(pairs, device=device),
            poly=poly,
        )
        table._host["values"] = vals
        return table

    @property
    def stacked(self) -> bool:
        return self.values.ndim == 2

    def lookup(self, h: torch.Tensor, frame: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Linear interpolation of l(h); clamps outside the grid, with the
        base index clamped to n-2 so the i+1 tap stays in bounds. A stacked
        table reads row ``frame`` (int64, shaped like ``h``)."""
        n = self.values.shape[-1]
        t = ((h - self.h0) * self.inv_dh).clamp(0.0, float(n - 1))
        i = torch.clamp(torch.floor(t).to(torch.int64), max=n - 2)
        f = t - i.to(t.dtype)
        row = self.pairs[i] if frame is None else self.pairs[frame, i]  # [..., 2]
        return row[..., 0] * (1.0 - f) + row[..., 1] * f

    def poly_rows(self) -> torch.Tensor:
        """The fit as the march kernel's data: [S, 10] f32 rows of
        (lo, hi, width, c0..c6), width = max(hi - lo, 1e-30), on the table's
        device; built and uploaded once per table and device."""
        dev = self.values.device
        if dev not in self._rows:
            rows = [
                [lo, hi, max(hi - lo, 1e-30), *coeffs] for lo, hi, coeffs in self.poly
            ]
            self._rows[dev] = torch.tensor(rows, dtype=torch.float32, device=dev)
        return self._rows[dev]


def _fit_piecewise_cheb(
    vals: np.ndarray,
    h_lo: float,
    dh: float,
    cum_tol: float = 2e-8,
    max_segments: int = 24,
) -> Optional[Tuple]:
    """Compile the l(h) table into piecewise Chebyshev polynomials.

    Segments split first at jump discontinuities of l(h) (lapse-rate
    boundaries such as the US-76 tropopause), then bisect until each fits so
    that the cumulative-integral deviation |∫(fit − l) dh| — the error the
    ODE's slope feels — stays within ``cum_tol``. Returns ((h_start, h_end,
    coeffs), ...) with (CHEB_DEG+1)-tuples, or None past ``max_segments``.
    """
    from numpy.polynomial import chebyshev as C

    vals = np.asarray(vals, np.float64)
    n = vals.shape[0]
    hs = h_lo + np.arange(n) * dh
    dv = np.abs(np.diff(vals))
    med = np.median(dv)
    jumps = np.where((dv > 10.0 * med) & (dv > 1e-11))[0] + 1
    bounds = [0] + [int(j) for j in jumps] + [n]

    def fit(a: int, b: int):
        if b - a == 1:  # single sample (e.g. the table-top edge): constant
            return np.array([vals[a]] + [0.0] * CHEB_DEG)
        deg = min(CHEB_DEG, b - a - 1)
        x = np.linspace(-1.0, 1.0, b - a)
        c = C.chebfit(x, vals[a:b], deg)
        err = C.chebval(x, c) - vals[a:b]
        if np.max(np.abs(np.cumsum(err))) * dh > cum_tol:
            return None
        return np.concatenate([c, np.zeros(CHEB_DEG + 1 - len(c))])

    segments = []
    stack = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)][::-1]
    while stack:
        a, b = stack.pop()
        if len(segments) + len(stack) >= max_segments:
            return None
        c = fit(a, b)
        if c is None:
            if b - a < 4:
                return None
            mid = (a + b) // 2
            stack.extend([(mid, b), (a, mid)])
            continue
        segments.append(
            (float(hs[a]), float(hs[b - 1]), tuple(float(v) for v in c))
        )
    return tuple(segments)


def _f32(x: float) -> float:
    """The float32 rounding of a host constant, as a Python float."""
    return float(np.float32(x))


def eval_l_poly(poly: Tuple, h: torch.Tensor,
                widths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Piecewise-Chebyshev l(h); clamps to the fitted range like ``lookup``.

    ``widths`` (``RefractionTable.poly_rows()[:, 2]``, on the device of
    ``h``) are the segments' widths as the divisors of t: the card divides
    by a tensor with IEEE division, as the CPU and the kernels do, but by a
    Python float as a product with its float32 reciprocal. Without them the
    widths are Python floats (the same quotients on the CPU)."""
    h = h.clamp(_f32(poly[0][0]), _f32(poly[-1][1]))
    out = torch.zeros_like(h)
    for k, (lo, hi, coeffs) in enumerate(poly):
        # zero-width segments exist (single-sample edge pieces)
        width = _f32(max(hi - lo, 1e-30)) if widths is None else widths[k]
        t = ((h - _f32(lo)) / width * 2.0 - 1.0).clamp(-1.0, 1.0)
        b1 = torch.zeros_like(t)
        b2 = torch.zeros_like(t)
        for c in coeffs[:0:-1]:  # Clenshaw recurrence
            b1, b2 = _f32(c) + 2.0 * t * b1 - b2, b1
        val = _f32(coeffs[0]) + t * b1 - b2
        if k == len(poly) - 1:
            mask = h >= _f32(lo)
        else:
            mask = (h >= _f32(lo)) & (h < _f32(poly[k + 1][0]))
        out = torch.where(mask, val, out)
    return out


def _eval_l(table: RefractionTable, h: torch.Tensor, frame=None) -> torch.Tensor:
    if table.poly is None:
        return table.lookup(h, frame)
    return eval_l_poly(table.poly, h, table.poly_rows()[:, 2])


def _acceleration(h, v, l, radius: Optional[float]):
    """h'' per the module-docstring ODE, given l(h); ``l`` None drops the
    refraction term (straight rays: zero on the flat shape, the curved-
    coordinate geometry term on the sphere)."""
    if radius is None:
        return torch.zeros_like(h) if l is None else l * (1.0 + v * v)
    inv_r = _f32(1.0 / radius)
    u = 1.0 + h * inv_r
    geom = (u * u + 2.0 * v * v) / u * inv_r
    return geom if l is None else l * (u * u + v * v) + geom


def _rk4_stages(h, v, dx: float, table: Optional[RefractionTable], radius, frame=None):
    """The four RK4 stages (k·h, k·v) of one step; l(h) at stage heights
    predicted from the carried slope (h, h + dx/2·v, h + dx·v), l2 serving
    both k2 and k3. ``table`` None integrates without refraction; a stacked
    table is read at each ray's ``frame``."""
    half = _f32(np.float32(0.5) * np.float32(dx))
    if table is None:
        l1 = l2 = l4 = None
    else:
        l1 = _eval_l(table, h, frame)
        l2 = _eval_l(table, h + half * v, frame)
        l4 = _eval_l(table, h + dx * v, frame)
    k1v = _acceleration(h, v, l1, radius)
    k1h = v
    k2h = v + half * k1v
    k2v = _acceleration(h + half * k1h, k2h, l2, radius)
    k3h = v + half * k2v
    k3v = _acceleration(h + half * k2h, k3h, l2, radius)
    k4h = v + dx * k3v
    k4v = _acceleration(h + dx * k3h, k4h, l4, radius)
    return (k1h, k2h, k3h, k4h), (k1v, k2v, k3v, k4v)


def _rk4_combine(x, ks, dx: float):
    """x + dx/6 · (k1 + 2 k2 + 2 k3 + k4)."""
    sixth = _f32(np.float32(dx) / np.float32(6.0))
    k1, k2, k3, k4 = ks
    return x + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _rk4_step(h, v, dx: float, table: Optional[RefractionTable], radius, frame=None):
    """One classic RK4 step of (h, h')."""
    kh, kv = _rk4_stages(h, v, dx, table, radius, frame)
    return _rk4_combine(h, kh, dx), _rk4_combine(v, kv, dx)


def _path_speed(h, v, radius):
    """dP/dx, the integrand of the reference's chord-sum path length
    (utils.rs:42-53): flat √(1+h'²); spherical √(((h+R)/R)² + h'²)."""
    if radius is None:
        return torch.sqrt(1.0 + v * v)
    u = 1.0 + h / radius
    return torch.sqrt(u * u + v * v)


def _rk4_step_quad(h, v, p, dx: float, table: Optional[RefractionTable], radius):
    """One RK4 step carrying (h, h', path length): P by the 4th-order
    quadrature of dP/dx over the same stages. (h, h') are bitwise those of
    ``_rk4_step`` from the same state."""
    kh, kv = _rk4_stages(h, v, dx, table, radius)
    half = _f32(np.float32(0.5) * np.float32(dx))
    k1h, k2h, k3h, k4h = kh
    f = (
        _path_speed(h, k1h, radius),
        _path_speed(h + half * k1h, k2h, radius),
        _path_speed(h + half * k2h, k3h, radius),
        _path_speed(h + dx * k3h, k4h, radius),
    )
    return _rk4_combine(h, kh, dx), _rk4_combine(v, kv, dx), _rk4_combine(p, f, dx)


def march_coarse(step: float) -> int:
    """Coarse RK4 window length in march steps (~800 m of ground distance)."""
    return max(1, int(800.0 // step))


def hermite_coeffs(coarse: int) -> np.ndarray:
    """The cubic Hermite basis (b00, b10, b01, b11) at t = j/C, j = 0..C:
    a host [4, C+1] float32 array, computed in float32 as the JAX package
    computes it. The one copy that ``hermite_plane`` (as Python floats) and
    ``hermite_window`` (as a device tensor) both read, so the two forms give
    bitwise-equal samples."""
    t = np.arange(coarse + 1, dtype=np.float32) / np.float32(coarse)
    t2 = t * t
    t3 = t2 * t
    two, three = np.float32(2.0), np.float32(3.0)
    return np.stack([
        two * t3 - three * t2 + np.float32(1.0),
        t3 - two * t2 + t,
        -two * t3 + three * t2,
        t3 - t2,
    ])


@functools.lru_cache(maxsize=16)
def _hermite_basis(coarse: int, device: torch.device) -> torch.Tensor:
    """``hermite_coeffs`` on a device, uploaded once (callers must not
    write to it)."""
    return torch.from_numpy(hermite_coeffs(coarse)).to(device)


def hermite_plane(h, vdx, h1, v1dx, coeffs: np.ndarray, j: int):
    """Fine Hermite sample ``j`` of a window from its node states, with
    ``vdx = v·dx_window`` and ``v1dx = v1·dx_window`` hoisted: the same
    products and the same left-to-right sum as element j of
    ``hermite_window``, so the values are bitwise equal."""
    b00, b10, b01, b11 = (float(c[j]) for c in coeffs)
    return b00 * h + b10 * vdx + b01 * h1 + b11 * v1dx


def hermite_window(h, v, h1, v1, dx_window: float, coarse: int):
    """Fine Hermite samples [..., C+1] of one coarse window from its node
    states (any leading shape)."""
    b00, b10, b01, b11 = _hermite_basis(coarse, h.device)
    return (
        b00 * h[..., None] + b10 * (v * dx_window)[..., None]
        + b01 * h1[..., None] + b11 * (v1 * dx_window)[..., None]
    )


def _seg_lengths(h_f: torch.Tensor, step: float, radius) -> torch.Tensor:
    """Chord lengths [..., n-1] between consecutive fine samples h_f[..., n],
    the reference's calc_dist (utils.rs:42-53): flat √(dx² + dh²); spherical
    with dx scaled by (h_avg + R)/R."""
    dxf = _f32(step)
    dh = h_f[..., 1:] - h_f[..., :-1]
    if radius is None:
        return torch.sqrt(_f32(np.float32(dxf) * np.float32(dxf)) + dh * dh)
    dx_eff = dxf * ((h_f[..., 1:] + h_f[..., :-1]) * 0.5 + radius) / radius
    return torch.sqrt(dx_eff * dx_eff + dh * dh)


def rk4_window(h, v, plen, step: float, coarse: int,
               table: Optional[RefractionTable], straight: bool, radius):
    """One coarse RK4 step + Hermite dense output + chord path lengths.

    Returns (h_f [..., C+1], plen_f [..., C+1], h1, v1) from the window-start
    state (h, v, plen) of any shape: exactly the values a ``march_scan``
    window produces from that state, so a captured window re-expands
    bitwise (the culled Rectilinear path and the tilt-0 K = 1 post-scan test
    rely on it).
    """
    dx = _f32(step * coarse)
    h1, v1 = _rk4_step(h, v, dx, None if straight else table, radius)
    h_f = hermite_window(h, v, h1, v1, dx, coarse)
    plen_f = torch.cat(
        [plen[..., None],
         plen[..., None] + torch.cumsum(_seg_lengths(h_f, step, radius), dim=-1)],
        dim=-1,
    )
    return h_f, plen_f, h1, v1


def _scan_start(alt: float, elev_rad: torch.Tensor, shape: EarthShape,
                n_steps: int, coarse: int):
    """Initial state of the fused scans: (alt, v0) shaped like ``elev_rad``,
    the clamped window length and the window count."""
    elev_rad = elev_rad.to(torch.float32)
    alt = torch.full_like(elev_rad, float(alt))
    coarse = max(1, min(int(coarse), n_steps))
    return alt, initial_slope(alt, elev_rad, shape), coarse, -(-n_steps // coarse)


def march_scan_light(alt, elev_rad: torch.Tensor, step: float, n_steps: int,
                     shape: EarthShape, table: Optional[RefractionTable],
                     straight: bool, consumer, init_carry, coarse: int = 1):
    """Fused march that hands each coarse window's NODE states to a consumer
    and never forms the fine samples itself (the JAX package's
    ``pass_nodes=True`` contract):

        carry, win_min = consumer(carry, k0, (h0, v0, h1, v1, p0), alive0)

    * ``k0`` — global fine index of the window start (a multiple of the
      clamped ``coarse``), a Python int;
    * ``(h0, v0)`` / ``(h1, v1)`` — ODE state at the window's two ends; the
      consumer evaluates fine samples with ``hermite_plane``;
    * ``p0`` — path length at the window start, advanced by the RK4
      quadrature of dP/dx (``_rk4_step_quad``), not by fine chords;
    * ``alive0`` — bool: no fine sample before the window fell below
      DEATH_ALTITUDE. Death inside a window is the consumer's to resolve.

    The consumer returns ``win_min``, the minimum of its fine samples
    j = 0..C-1, from which the scan keeps the death flag. State may have any
    shape (everything is elementwise). Returns the final carry.
    """
    h, v, coarse, n_coarse = _scan_start(alt, elev_rad, shape, n_steps, coarse)
    radius = shape.radius
    tb = None if straight else table
    dx = _f32(step * coarse)
    p = torch.zeros_like(h)
    dead = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    user = init_carry
    for i in range(n_coarse):
        h1, v1, p1 = _rk4_step_quad(h, v, p, dx, tb, radius)
        user, win_min = consumer(user, i * coarse, (h, v, h1, v1, p), ~dead)
        dead = dead | (win_min < DEATH_ALTITUDE)
        h, v, p = h1, v1, p1
    return user


def march_scan(alt, elev_rad: torch.Tensor, step: float, n_steps: int,
               shape: EarthShape, table: Optional[RefractionTable],
               straight: bool, consumer, init_carry, coarse: int = 1,
               with_slope: bool = False):
    """Fused march that streams each coarse window's fine samples to a
    consumer without forming the [..., N] altitude grid:

        carry = consumer(carry, k0, h_f, plen_f, alive[, v, h1, v1])

    * ``h_f`` / ``plen_f`` — [..., C+1] fine altitudes / cumulative chord
      path lengths at k0..k0+C (``rk4_window``; windows share their ends);
    * ``alive`` — [..., C]: segment j is marched iff no sample before
      k0 + j fell below DEATH_ALTITUDE (the path-death rule, utils.rs:
      159-171, as ``ops.combine.ray_alive_mask``);
    * ``v``, ``h1``, ``v1`` — with ``with_slope``, the window-start slope
      (with h_f[..., 0] and plen_f[..., 0] enough to re-integrate the window
      later) and the window-end node.

    Integrates ceil(n_steps/C)·C steps; the consumer masks the tail
    (k0 + j >= n_steps). Returns the final carry.
    """
    h, v, coarse, n_coarse = _scan_start(alt, elev_rad, shape, n_steps, coarse)
    plen = torch.zeros_like(h)
    dead = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    user = init_carry
    for i in range(n_coarse):
        h_f, plen_f, h1, v1 = rk4_window(h, v, plen, step, coarse, table,
                                         straight, shape.radius)
        pref = torch.cumsum((h_f[..., :-1] < DEATH_ALTITUDE).to(torch.int32), dim=-1)
        no_prior = torch.cat([torch.zeros_like(pref[..., :1]), pref[..., :-1]], dim=-1)
        alive = (~dead)[..., None] & (no_prior == 0)
        if with_slope:
            user = consumer(user, i * coarse, h_f, plen_f, alive, v, h1, v1)
        else:
            user = consumer(user, i * coarse, h_f, plen_f, alive)
        dead = dead | (pref[..., -1] > 0)
        h, v, plen = h1, v1, plen_f[..., -1]
    return user


def _check_frames(table: RefractionTable, b: int, rays_per_frame: Optional[int]) -> None:
    """A stacked table must hold a table for every frame of ``b`` rays."""
    if not rays_per_frame or -(-b // rays_per_frame) > table.values.shape[0]:
        raise ValueError(f"a stacked table of {table.values.shape[0]} frames needs "
                         f"rays_per_frame for {b} rays, got {rays_per_frame}")


def _ray_frames(table: Optional[RefractionTable], b: int,
                rays_per_frame: Optional[int], device) -> Optional[torch.Tensor]:
    """Each ray's frame, b // rays_per_frame, for a stacked table (int64
    [B]); None for a table shared by every ray."""
    if table is None or not table.stacked:
        return None
    _check_frames(table, b, rays_per_frame)
    return torch.arange(b, device=device) // int(rays_per_frame)


def march_nodes_plain(alt, v0, dx: float, n_coarse: int,
                      table: RefractionTable, radius: Optional[float],
                      rays_per_frame: Optional[int] = None):
    """Plain PyTorch coarse node loop: (h, v) nodes [n_coarse+1, B] f32.
    A stacked table gives ray b the l(h) of frame b // ``rays_per_frame``."""
    frame = _ray_frames(table, alt.shape[0], rays_per_frame, alt.device)
    hs = [alt]
    vs = [v0]
    h, v = alt, v0
    for _ in range(n_coarse):
        h, v = _rk4_step(h, v, dx, table, radius, frame)
        hs.append(h)
        vs.append(v)
    return torch.stack(hs), torch.stack(vs)


def initial_slope(alt: torch.Tensor, elev_rad: torch.Tensor,
                  shape: EarthShape) -> torch.Tensor:
    """dh/dx at x=0 for a ray launched at ``elev_rad`` above local horizontal."""
    t = torch.tan(elev_rad)
    if shape.is_flat:
        return t
    return (1.0 + alt / shape.radius) * t


def _straight_dense(alt, elev_rad, step: float, n_steps: int,
                    shape: EarthShape) -> torch.Tensor:
    """Closed-form straight-ray altitudes [N+1, B]; a spherical chord that
    recedes past e+φ = 90° is clamped to 1e9 m (open sky)."""
    x = (torch.arange(n_steps + 1, dtype=torch.float32, device=alt.device)[:, None]
         * _f32(step))
    if shape.is_flat:
        return alt[None, :] + torch.tan(elev_rad)[None, :] * x
    r = _f32(shape.radius)
    phi = x / r
    c = torch.cos(elev_rad + phi)  # [N+1, B]
    # cancellation-free r0·(cos e − cos(e+φ))/cos(e+φ), with
    # cos e − cos(e+φ) = 2·sin(e+φ/2)·sin(φ/2)
    num = 2.0 * torch.sin(elev_rad + 0.5 * phi) * torch.sin(0.5 * phi)
    far = c <= 1e-9
    h = alt[None, :] + (r + alt)[None, :] * num / torch.where(far, 1.0, c)
    return torch.where(far, 1e9, h)


def march_rays(
    alt,
    elev_rad: torch.Tensor,
    step: float,
    n_steps: int,
    shape: EarthShape,
    table: Optional[RefractionTable],
    straight: bool,
    coarse: int = 1,
    rays_per_frame: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """March a batch of rays N fixed steps: ([B, N+1] h, [B, N+1] path length).

    ``alt`` is a scalar or [B] (meters), ``elev_rad`` [B] on the target
    device. ``coarse`` = C > 1 integrates RK4 at C·step and fills the fine
    grid by cubic Hermite dense output: ``march_nodes_plain``,
    ``hermite_fill`` and ``_finish_march``, on the device of the inputs. With a
    stacked ``table`` (a sweep's per-frame atmospheres) ray b takes the
    l(h) of frame b // ``rays_per_frame``.
    """
    elev_rad = elev_rad.to(torch.float32)
    if isinstance(alt, torch.Tensor):
        alt = alt.to(device=elev_rad.device, dtype=torch.float32)
        alt = alt.expand(elev_rad.shape).contiguous()
    else:  # filled on the device: no blocking copy from pageable host memory
        alt = torch.full(elev_rad.shape, float(alt), dtype=torch.float32,
                         device=elev_rad.device)
    radius = shape.radius
    if table is None or straight:
        h_fine = _straight_dense(alt, elev_rad, step, n_steps, shape)
        return _finish_march(h_fine, step, radius)

    v0 = initial_slope(alt, elev_rad, shape)
    coarse = max(1, min(int(coarse), n_steps))
    n_coarse = -(-n_steps // coarse)
    dx = _f32(step * coarse)
    h_nodes, v_nodes = march_nodes_plain(alt, v0, dx, n_coarse, table, radius,
                                         rays_per_frame)
    h_fine = hermite_fill(h_nodes, v_nodes, dx, coarse, n_steps)
    return _finish_march(h_fine, step, radius)


def hermite_fill(h_nodes, v_nodes, dx: float, coarse: int, n_steps: int):
    """Fine altitudes [N+1, B] from the nodes [n_coarse+1, B]: the nodes
    themselves when C = 1, else the cubic Hermite samples t = j/C, j < C, of
    each coarse window, then the last node, cut to N+1."""
    if coarse == 1:
        return h_nodes[: n_steps + 1]
    h00, h10, h01, h11 = _hermite_basis(coarse, h_nodes.device)[:, :coarse, None, None]
    hl = h_nodes[:-1][None]  # [1, Nc, B]
    hr = h_nodes[1:][None]
    vl = v_nodes[:-1][None] * dx
    vr = v_nodes[1:][None] * dx
    seg = h00 * hl + h10 * vl + h01 * hr + h11 * vr  # [C, Nc, B]
    return torch.cat(
        [seg.permute(1, 0, 2).reshape(-1, seg.shape[2]), h_nodes[-1:]],
        dim=0,
    )[: n_steps + 1]


def _finish_march(h_fine, step: float, radius):
    """[N+1, B] fine altitudes → ([B, N+1] h, [B, N+1] path length), the
    path length summed like the reference's calc_dist (utils.rs:42-53).

    The prefix sum runs in float64, rounded once: what the CPU's float32
    cumsum does anyway, and on the card exact where a float32 scan drifts
    by ~16 ulp over 4000 chords (K2 sums the same way)."""
    h_out = h_fine.transpose(0, 1).contiguous()  # [B, N+1]
    p_out = torch.cat(
        [torch.zeros(h_out.shape[:-1] + (1,), dtype=torch.float32,
                     device=h_out.device),
         torch.cumsum(_seg_lengths(h_out, step, radius), dim=-1,
                      dtype=torch.float64).to(torch.float32)],
        dim=-1,
    )
    return h_out, p_out
