"""The reference's gzip(bincode(AllData)) metadata: reader and writer.

Counterpart of ``atm_raytracer_tpu/meta/bincode.py``, with the same byte
layout: both packages write byte-identical artifacts for the same hits, and
each reads the other's. Host numpy only; ``decode_alldata`` returns a
``HitBuffer`` of CPU tensors.

The reference serializes ``AllData{params: Params, result: Vec<Vec<
ResultPixel>>}`` with bincode 1.x defaults — little-endian, fixed-width
integers, u32 enum-variant tags, u64 sequence lengths, 1-byte bools and
Option discriminants — then gzips it (src/generator/mod.rs:26-45; decoded in
src/viewer/mod.rs:17-31). Every field below is transcribed from the in-tree
type definitions:

* ``Params{scene, view, model, env, straight_rays, simulation_step, output}``
  (params.rs:496-505)
* ``Scene{terrain_folder, objects, [skip], terrain_alpha}`` (params.rs:110-116)
* ``SerializableObject{position: Coords, shape: Shape, color}``
  (object/mod.rs:188-191), ``Shape::{Frustum, Billboard{.., Image}}``
  (object/mod.rs:120-132), ``Image{[skip image], path}`` (object/mod.rs:76-81)
* ``View{position, frame, coloring, fog_distance}`` (params.rs:298-304),
  ``Position``/``Altitude`` (params.rs:17-39), ``Frame`` (params.rs:144-152)
* ``Coloring::{Simple, Shading}`` (params.rs:215-228), ``ColorPalette``
  (coloring/shading.rs:9-14)
* ``EarthModel`` 8 variants (utils/earth_model/mod.rs:19-28)
* ``Output{file, file_metadata, width: u16, height: u16, ticks,
  vertical_ticks, show_eye_level, show_flat_horizon, generator}``
  (params.rs:394-413), ``Tick``/``VerticalTick`` (params.rs:325-368),
  ``GeneratorDef`` (params.rs:387-392)
* ``ResultPixel{elevation_angle, azimuth, trace_points}`` /
  ``TracePoint{lat, lon, distance, elevation, path_length, normal, color}`` /
  ``PixelColor::{Terrain(f64), Rgba(Color)}`` (generators/mod.rs:14-48)

Two layout details are NOT pinned by the in-tree sources and are handled
defensively:

1. ``Params.env`` is an ``atm_refraction::Environment`` — an out-of-tree
   crate type whose bincode layout we cannot transcribe. The decoder SKIPS
   it by scanning for the ``Output`` struct that follows it: a candidate
   offset is accepted only when an ``Output`` parses there AND the
   ``Vec<Vec<ResultPixel>>`` after it starts with the parsed
   height/width AND the preamble (bool + plausible simulation_step) sits
   immediately before — a conjunction that cannot occur by accident inside
   the atmosphere bytes. The raw env bytes are preserved for round-trips.
2. nalgebra's serde for ``Vector3<f64>`` may or may not emit a u64 length
   prefix depending on the crate minor version. Detected once per file from
   the first vector (a prefix reads as the integer 3; as a leading f64 it
   would be 1.5e-322, which no real direction/normal contains).
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

GZIP_MAGIC = b"\x1f\x8b"

_EARTH_VARIANTS = (
    "SimpleSphere", "Spherical", "Ellipsoid", "Wgs84",
    "AzimuthalEquidistant", "FlatDistorted", "ObserverAe", "SimpleObserverAe",
)
# dict keys must match models.earth.EarthModel.from_config's grammar
# (bincode itself serializes no field names — layout is positional)
_EARTH_FIELDS = {1: ("radius",), 2: ("a", "b"), 6: ("projection_radius",)}
_GENERATORS = ("Fast", "InterpolatingRectilinear", "Rectilinear")
_PALETTES = ("Legacy", "Improved")


class BincodeError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.d = data
        self.p = pos
        self.vec3_prefixed: Optional[bool] = None

    def _take(self, fmt: str, size: int):
        if self.p + size > len(self.d):
            raise BincodeError("truncated")
        v = struct.unpack_from(fmt, self.d, self.p)[0]
        self.p += size
        return v

    def u8(self):
        return self._take("<B", 1)

    def boolean(self):
        v = self.u8()
        if v > 1:
            raise BincodeError(f"bool byte {v}")
        return bool(v)

    def u16(self):
        return self._take("<H", 2)

    def u32(self):
        return self._take("<I", 4)

    def u64(self):
        return self._take("<Q", 8)

    def f64(self):
        return self._take("<d", 8)

    def tag(self, n_variants: int) -> int:
        t = self.u32()
        if t >= n_variants:
            raise BincodeError(f"enum tag {t} >= {n_variants}")
        return t

    def string(self, max_len: int = 1 << 20) -> str:
        n = self.u64()
        if n > max_len or self.p + n > len(self.d):
            raise BincodeError(f"string len {n}")
        s = self.d[self.p:self.p + n].decode("utf-8")
        self.p += n
        return s

    def option(self, read_fn):
        disc = self.u8()
        if disc > 1:
            raise BincodeError(f"option byte {disc}")
        return read_fn() if disc else None

    def vector3(self) -> Tuple[float, float, float]:
        if self.vec3_prefixed is None:
            self.vec3_prefixed = (
                self.p + 8 <= len(self.d)
                and struct.unpack_from("<Q", self.d, self.p)[0] == 3
            )
        if self.vec3_prefixed:
            if self.u64() != 3:
                raise BincodeError("vector3 length prefix != 3")
        return (self.f64(), self.f64(), self.f64())


# -- Params components -------------------------------------------------------


def _read_altitude(r: _Reader) -> dict:
    t = r.tag(2)
    return {("Absolute", "Relative")[t]: r.f64()}


def _read_position(r: _Reader) -> dict:
    return {
        "latitude": r.f64(),
        "longitude": r.f64(),
        "altitude": _read_altitude(r),
    }


def _read_frame(r: _Reader) -> dict:
    return {
        "direction": r.f64(),
        "tilt": r.f64(),
        "fov": r.f64(),
        "max_distance": r.f64(),
    }


def _read_coloring(r: _Reader) -> dict:
    t = r.tag(2)
    if t == 0:
        return {"Simple": {"water_level": r.f64(), "max_distance": r.f64()}}
    water = r.f64()
    ambient = r.f64()
    light_dir = r.vector3()
    palette = _PALETTES[r.tag(2)]
    # Params stores the LOWERED Coloring (world-frame light vector); keep it
    # verbatim — the viewer re-renders with it directly.
    return {"Shading": {
        "water_level": water, "ambient_light": ambient,
        "light_dir_world": list(light_dir), "palette": palette,
    }}


def _read_view(r: _Reader) -> dict:
    return {
        "position": _read_position(r),
        "frame": _read_frame(r),
        "coloring": _read_coloring(r),
        "fog_distance": r.option(r.f64),
    }


def _read_color(r: _Reader) -> dict:
    return {"r": r.f64(), "g": r.f64(), "b": r.f64(), "a": r.f64()}


def _read_shape(r: _Reader) -> dict:
    t = r.tag(2)
    if t == 0:
        return {"Frustum": {"r1": r.f64(), "r2": r.f64(), "height": r.f64()}}
    return {"Billboard": {
        "width": r.f64(), "height": r.f64(), "texture_path": r.string(),
    }}


def _read_object(r: _Reader) -> dict:
    coords = {"lat": r.f64(), "lon": r.f64(), "elev": r.f64()}
    shape = _read_shape(r)
    color = _read_color(r)
    return {"position": coords, "shape": shape, "color": color}


def _read_scene(r: _Reader) -> dict:
    folder = r.string()
    n = r.u64()
    if n > 1 << 20:
        raise BincodeError(f"objects len {n}")
    objects = [_read_object(r) for _ in range(n)]
    return {
        "terrain_folder": folder,
        "objects": objects,
        "terrain_alpha": r.f64(),
    }


def _read_earth_model(r: _Reader):
    t = r.tag(8)
    name = _EARTH_VARIANTS[t]
    fields = _EARTH_FIELDS.get(t)
    if fields is None:
        return name
    return {name: {f: r.f64() for f in fields}}


def _read_tick(r: _Reader, single_angle: str) -> dict:
    t = r.tag(2)
    if t == 0:
        return {"Single": {
            single_angle: r.f64(), "size": r.u32(), "labelled": r.boolean(),
        }}
    return {"Multiple": {
        "bias": r.f64(), "step": r.f64(), "size": r.u32(),
        "labelled": r.boolean(),
    }}


def _read_output(r: _Reader) -> dict:
    out = {
        "file": r.string(max_len=1 << 12),
        "file_metadata": r.option(lambda: r.string(max_len=1 << 12)),
        "width": r.u16(),
        "height": r.u16(),
    }
    n_ticks = r.u64()
    if n_ticks > 4096:
        raise BincodeError(f"ticks len {n_ticks}")
    out["ticks"] = [_read_tick(r, "azimuth") for _ in range(n_ticks)]
    n_v = r.u64()
    if n_v > 4096:
        raise BincodeError(f"vertical ticks len {n_v}")
    out["vertical_ticks"] = [_read_tick(r, "elevation") for _ in range(n_v)]
    out["show_eye_level"] = r.boolean()
    out["show_flat_horizon"] = r.boolean()
    out["generator"] = _GENERATORS[r.tag(3)]
    return out


# -- result ------------------------------------------------------------------

# ResultPixel header: elevation_angle f64, azimuth f64, Vec len u64
# (generators/mod.rs:14-19 under bincode 1.x fixed-int encoding).
_HDR_DT = np.dtype([("elev", "<f8"), ("az", "<f8"), ("n", "<u8")])


def _tp1_terrain_dtype(prefixed: bool) -> np.dtype:
    """Pixel record for the dominant terrain case: header + exactly one
    TracePoint carrying PixelColor::Terrain(f64) (generators/mod.rs:21-48)."""
    fields = [("elev", "<f8"), ("az", "<f8"), ("n", "<u8"),
              ("lat", "<f8"), ("lon", "<f8"), ("dist", "<f8"),
              ("el", "<f8"), ("plen", "<f8")]
    if prefixed:
        fields.append(("v3len", "<u8"))
    fields += [("nx", "<f8"), ("ny", "<f8"), ("nz", "<f8"),
               ("ctag", "<u4"), ("alpha", "<f8")]
    return np.dtype(fields)


def _read_result(r: _Reader, height: int, width: int):
    """Vec<Vec<ResultPixel>> → (elev [H,W], az [H,W], runs, scalars).

    A 1080p artifact is ~2M pixels; per-pixel struct.unpack loops take
    minutes of interpreted Python on a 1-core host. The two dominant pixel
    shapes — sky (0 trace points) and single-terrain-hit — are instead
    parsed as vectorized RUNS: interpret the remaining row optimistically
    as consecutive fixed-size records via np.frombuffer, accept the longest
    prefix whose self-describing fields (trace len, color tag, vec3 prefix)
    match, and fall back to the scalar parser for the first mismatching
    pixel. Returns ``runs`` = [(i, j0, record-array)] single-terrain spans
    and ``scalars`` = [(i, j, [trace tuples])] for everything else.
    """
    h = r.u64()
    if h != height:
        raise BincodeError(f"result rows {h} != height {height}")
    elev = np.zeros((height, width), np.float64)
    az = np.zeros((height, width), np.float64)
    d = r.d
    runs: List[tuple] = []
    scalars: List[tuple] = []
    for i in range(height):
        w = r.u64()
        if w != width:
            raise BincodeError(f"result row {i} cols {w} != width {width}")
        j = 0
        while j < width:
            o = r.p
            rem = width - j
            # run of sky pixels (n_tp == 0): bare 24-byte headers
            m0 = min(rem, max(0, (len(d) - o) // _HDR_DT.itemsize))
            if m0 > 0:
                hdr = np.frombuffer(d, dtype=_HDR_DT, count=m0, offset=o)
                nz = np.flatnonzero(hdr["n"])
                q = int(nz[0]) if nz.size else m0
                if q > 0:
                    elev[i, j:j + q] = hdr["elev"][:q]
                    az[i, j:j + q] = hdr["az"][:q]
                    r.p = o + q * _HDR_DT.itemsize
                    j += q
                    continue
            # run of single-terrain-hit pixels (n_tp == 1, Terrain color)
            if r.vec3_prefixed is not None:
                dt1 = _tp1_terrain_dtype(r.vec3_prefixed)
                m1 = min(rem, max(0, (len(d) - o) // dt1.itemsize))
                if m1 > 0:
                    rec = np.frombuffer(d, dtype=dt1, count=m1, offset=o)
                    ok = (rec["n"] == 1) & (rec["ctag"] == 0)
                    if r.vec3_prefixed:
                        ok &= rec["v3len"] == 3
                    bad = np.flatnonzero(~ok)
                    q = int(bad[0]) if bad.size else m1
                    if q > 0:
                        elev[i, j:j + q] = rec["elev"][:q]
                        az[i, j:j + q] = rec["az"][:q]
                        runs.append((i, j, rec[:q]))
                        r.p = o + q * dt1.itemsize
                        j += q
                        continue
            # scalar fallback: one pixel, arbitrary trace points
            elev[i, j] = r.f64()
            az[i, j] = r.f64()
            n_tp = r.u64()
            if n_tp > 4096:
                raise BincodeError(f"trace_points len {n_tp}")
            tps = []
            for _ in range(n_tp):
                lat = r.f64()
                lon = r.f64()
                dist = r.f64()
                el = r.f64()
                plen = r.f64()
                normal = r.vector3()
                ct = r.tag(2)
                if ct == 0:
                    kind, rgba = 0, (0.0, 0.0, 0.0, r.f64())
                else:
                    c = _read_color(r)
                    kind, rgba = 1, (c["r"], c["g"], c["b"], c["a"])
                tps.append((lat, lon, dist, el, plen, normal, kind, rgba))
            if tps:
                scalars.append((i, j, tps))
            j += 1
    return elev, az, runs, scalars


def _build_hitbuffer(height, width, runs, scalars, lat0, lon0, step):
    import torch

    from ..generators.base import HitBuffer

    k = max((len(tps) for _, _, tps in scalars), default=0)
    if runs:
        k = max(k, 1)
    k = max(k, 1)
    shape = (height, width, k)
    valid = np.zeros(shape, bool)
    f = {n: np.zeros(shape, np.float32) for n in
         ("dlat", "dlon", "distance", "elevation", "path_length")}
    normal = np.zeros(shape + (3,), np.float32)
    kind = np.zeros(shape, np.int32)
    rgba = np.zeros(shape + (4,), np.float32)
    # f64 values from a (possibly hostile) artifact may exceed f32 range;
    # numpy's saturating cast is the behavior we want — silence its warning
    with np.errstate(over="ignore"):
        for i, j0, rec in runs:
            sl = (i, slice(j0, j0 + len(rec)), 0)
            valid[sl] = True
            f["dlat"][sl] = rec["lat"] - lat0
            f["dlon"][sl] = rec["lon"] - lon0
            f["distance"][sl] = rec["dist"]
            f["elevation"][sl] = rec["el"]
            f["path_length"][sl] = rec["plen"]
            normal[i, j0:j0 + len(rec), 0, 0] = rec["nx"]
            normal[i, j0:j0 + len(rec), 0, 1] = rec["ny"]
            normal[i, j0:j0 + len(rec), 0, 2] = rec["nz"]
            rgba[i, j0:j0 + len(rec), 0, 3] = rec["alpha"]
        for i, j, tps in scalars:
            for s, (lat, lon, dist, el, plen, nrm, kd, col) in enumerate(tps):
                valid[i, j, s] = True
                f["dlat"][i, j, s] = lat - lat0
                f["dlon"][i, j, s] = lon - lon0
                f["distance"][i, j, s] = dist
                f["elevation"][i, j, s] = el
                f["path_length"][i, j, s] = plen
                normal[i, j, s] = nrm
                kind[i, j, s] = kd
                rgba[i, j, s] = col
    # HitBuffer contract (generators/base.py): key is the march sort
    # position with distance = key·step; reconstruct it from the stored
    # distance so pack/merge consumers see consistent keys.
    key = np.where(
        valid, f["distance"] / np.float32(step), np.inf
    ).astype(np.float32)
    t = torch.from_numpy
    return HitBuffer(
        valid=t(valid), key=t(key), dlat=t(f["dlat"]), dlon=t(f["dlon"]),
        distance=t(f["distance"]), elevation=t(f["elevation"]),
        path_length=t(f["path_length"]), normal=t(normal), kind=t(kind),
        rgba=t(rgba),
    )


# -- top level ---------------------------------------------------------------


def _find_output_anchor(r: _Reader, data: bytes, scene_end: int):
    """Locate Output start after the opaque Environment bytes.

    Accepts offset o iff: a full Output parses at o, the result vector
    after it opens with (height, width) matching the Output, and the 9
    preamble bytes before o hold a valid bool + plausible simulation_step.
    """
    for o in range(scene_end + 9, len(data) - 16):
        if data[o - 9] > 1:  # straight_rays bool
            continue
        step = struct.unpack_from("<d", data, o - 8)[0]
        if not (1e-3 <= step <= 1e7):
            continue
        cand = _Reader(data, o)
        cand.vec3_prefixed = r.vec3_prefixed
        try:
            out = _read_output(cand)
            if struct.unpack_from("<Q", data, cand.p)[0] != out["height"]:
                continue
            if out["height"] > 0:
                if (
                    struct.unpack_from("<Q", data, cand.p + 8)[0]
                    != out["width"]
                ):
                    continue
        except (BincodeError, UnicodeDecodeError, struct.error):
            continue
        return o, bool(data[o - 9]), step, out, cand.p
    raise BincodeError("could not locate Output struct after Environment")


def decode_alldata(blob: bytes):
    """gzip(bincode(AllData)) → (params_dict, elev [H,W], az [H,W], HitBuffer).

    ``params_dict`` carries scene/view/model/output plus ``env_raw`` (the
    opaque atm-refraction Environment bytes, preserved for round-trips).
    """
    if blob[:2] == GZIP_MAGIC:
        try:
            data = gzip.decompress(blob)
        except (OSError, EOFError, zlib.error) as e:
            # zlib.error is not a ValueError/OSError; normalize so callers
            # (cli view's ERROR line, main.rs:36-38 analog) catch one family
            raise BincodeError(f"corrupt gzip stream: {e}") from e
    else:
        data = blob
    r = _Reader(data)
    scene = _read_scene(r)
    view = _read_view(r)
    model = _read_earth_model(r)
    env_start = r.p
    o, straight, step, output, result_pos = _find_output_anchor(r, data, r.p)
    env_raw = data[env_start:o - 9]
    rr = _Reader(data, result_pos)
    rr.vec3_prefixed = r.vec3_prefixed
    elev, az, runs, scalars = _read_result(
        rr, output["height"], output["width"]
    )
    if rr.p != len(data):
        raise BincodeError(
            f"trailing bytes: parsed to {rr.p} of {len(data)}"
        )
    pos = view["position"]
    hits = _build_hitbuffer(
        output["height"], output["width"], runs, scalars,
        pos["latitude"], pos["longitude"], step,
    )
    params = {
        "scene": scene,
        "view": view,
        "model": model,
        "env_raw": env_raw,
        "straight_rays": straight,
        "simulation_step": step,
        "output": output,
    }
    return params, elev, az, hits


# -- encoder (write-side interop + round-trip self-test) ---------------------


class _Writer:
    def __init__(self, vec3_prefixed: bool = False):
        self.b = bytearray()
        self.vec3_prefixed = vec3_prefixed

    def u8(self, v):
        self.b += struct.pack("<B", v)

    def boolean(self, v):
        self.u8(1 if v else 0)

    def u16(self, v):
        self.b += struct.pack("<H", v)

    def u32(self, v):
        self.b += struct.pack("<I", v)

    def u64(self, v):
        self.b += struct.pack("<Q", v)

    def f64(self, v):
        self.b += struct.pack("<d", float(v))

    def string(self, s):
        raw = s.encode("utf-8")
        self.u64(len(raw))
        self.b += raw

    def option(self, v, write_fn):
        if v is None:
            self.u8(0)
        else:
            self.u8(1)
            write_fn(v)

    def vector3(self, v):
        if self.vec3_prefixed:
            self.u64(3)
        for x in v:
            self.f64(x)


def _write_altitude(w: _Writer, alt: dict):
    ((name, value),) = alt.items()
    w.u32(("Absolute", "Relative").index(name))
    w.f64(value)


def _write_position(w: _Writer, p: dict):
    w.f64(p["latitude"])
    w.f64(p["longitude"])
    _write_altitude(w, p["altitude"])


def _write_coloring(w: _Writer, c: dict):
    if "Simple" in c:
        w.u32(0)
        w.f64(c["Simple"]["water_level"])
        w.f64(c["Simple"]["max_distance"])
    else:
        s = c["Shading"]
        w.u32(1)
        w.f64(s["water_level"])
        w.f64(s["ambient_light"])
        w.vector3(s["light_dir_world"])
        w.u32(_PALETTES.index(s["palette"]))


def _write_shape(w: _Writer, s: dict):
    if "Frustum" in s:
        w.u32(0)
        for f in ("r1", "r2", "height"):
            w.f64(s["Frustum"][f])
    else:
        b = s["Billboard"]
        w.u32(1)
        w.f64(b["width"])
        w.f64(b["height"])
        w.string(b["texture_path"])


def _write_tick(w: _Writer, t: dict, single_angle: str):
    if "Single" in t:
        w.u32(0)
        w.f64(t["Single"][single_angle])
        w.u32(t["Single"]["size"])
        w.boolean(t["Single"]["labelled"])
    else:
        m = t["Multiple"]
        w.u32(1)
        w.f64(m["bias"])
        w.f64(m["step"])
        w.u32(m["size"])
        w.boolean(m["labelled"])


def _write_output(w: _Writer, out: dict):
    w.string(out["file"])
    w.option(out.get("file_metadata"), w.string)
    w.u16(out["width"])
    w.u16(out["height"])
    w.u64(len(out.get("ticks", ())))
    for t in out.get("ticks", ()):
        _write_tick(w, t, "azimuth")
    w.u64(len(out.get("vertical_ticks", ())))
    for t in out.get("vertical_ticks", ()):
        _write_tick(w, t, "elevation")
    w.boolean(out.get("show_eye_level", False))
    w.boolean(out.get("show_flat_horizon", False))
    w.u32(_GENERATORS.index(out.get("generator", "Fast")))


def encode_environment(shape_radius, atmosphere_def: dict,
                       wavelength: float) -> bytes:
    """Best-effort bincode encoding of ``atm_refraction::Environment``.

    Known fault, shared with the JAX package's writer on purpose: the
    ``humidity`` of the atmosphere definition is not written, so a
    humidity profile does not survive a ``.dat`` artifact (the reader skips
    this segment and the viewer does not use it). Both packages keep one
    byte layout until they change it together.

    ``Environment{shape, atmosphere, wavelength}`` field order is pinned by
    the construction literal (src/generator/params.rs:519-523).
    ``EarthShape::{Flat, Spherical{radius}}`` variant order is as the crate
    documents it (SURVEY §2a; tag 0 = Flat, 1 = Spherical).

    The ``atmosphere`` segment is the one layout this repo CANNOT pin: the
    crate's runtime ``Atmosphere`` (post ``from_def``) is out-of-tree and
    its serde shape — whether it stores the def or derived spline
    coefficients — is unknowable without the crate source (PARITY.md). We
    encode the *definition* grammar (the ``AtmosphereDef`` serde tree from
    README.md:281-323 under bincode rules) as the documented stand-in:
    deterministic, self-describing, and skipped opaquely by our own
    decoder's Output-anchor scan, so write→read round-trips are exact
    regardless. ``shape_radius`` is ``None`` for Flat.

    Layout (bincode 1.x fixed-int little-endian):
      shape: u32 tag [+ f64 radius]
      atmosphere (AtmosphereDef):
        pressure: f64 altitude, f64 pressure
        first_temperature_function: TempFn
        next_functions: u64 len + (f64 altitude, TempFn)*
        temperature_fixed_point: Option<(f64 altitude, f64 temperature)>
      wavelength: f64
      TempFn: u32 tag — 0 Linear{gradient f64}
                        1 Spline{boundary_condition: u32 tag
                                   (0 Natural | 1 Derivatives(2×f64)
                                    | 2 SecondDerivatives(2×f64)),
                                 points: u64 len + (f64, f64)*}
    """
    w = _Writer()
    if shape_radius is None:
        w.u32(0)
    else:
        w.u32(1)
        w.f64(shape_radius)

    def temp_fn(fn: dict):
        if "Linear" in fn:
            w.u32(0)
            w.f64(fn["Linear"]["gradient"])
            return
        sp = fn["Spline"]
        w.u32(1)
        bc = sp["boundary_condition"]
        if bc == "Natural" or bc == ("Natural",):
            w.u32(0)
        else:
            ((name, vals),) = (
                bc.items() if isinstance(bc, dict) else ((bc[0], bc[1:]),)
            )
            w.u32(("Natural", "Derivatives", "SecondDerivatives").index(name))
            seq = vals[0] if len(vals) == 1 and isinstance(
                vals[0], (list, tuple)
            ) else vals
            for v in seq:
                w.f64(v)
        pts = sp["points"]
        w.u64(len(pts))
        for a, t in pts:
            w.f64(a)
            w.f64(t)

    p = atmosphere_def["pressure"]
    w.f64(p["altitude"])
    w.f64(p["pressure"])
    temp_fn(atmosphere_def["first_temperature_function"])
    nxt = atmosphere_def.get("next_functions", ())
    w.u64(len(nxt))
    for entry in nxt:
        w.f64(entry["altitude"])
        temp_fn(entry["function"])
    tfp = atmosphere_def.get("temperature_fixed_point")
    if tfp is None:
        w.u8(0)
    else:
        w.u8(1)
        w.f64(tfp["altitude"])
        w.f64(tfp["temperature"])
    w.f64(wavelength)
    return bytes(w.b)


def encode_alldata(params: dict, elev, az, hits, *, vec3_prefixed=False,
                   compress=True) -> bytes:
    """Inverse of :func:`decode_alldata` (layout self-test + write interop)."""
    w = _Writer(vec3_prefixed)
    scene = params["scene"]
    w.string(scene["terrain_folder"])
    w.u64(len(scene.get("objects", ())))
    for ob in scene.get("objects", ()):
        for f in ("lat", "lon", "elev"):
            w.f64(ob["position"][f])
        _write_shape(w, ob["shape"])
        for f in ("r", "g", "b", "a"):
            w.f64(ob["color"][f])
    w.f64(scene["terrain_alpha"])
    view = params["view"]
    _write_position(w, view["position"])
    for f in ("direction", "tilt", "fov", "max_distance"):
        w.f64(view["frame"][f])
    _write_coloring(w, view["coloring"])
    w.option(view.get("fog_distance"), w.f64)
    model = params["model"]
    if isinstance(model, str):
        w.u32(_EARTH_VARIANTS.index(model))
    else:
        ((name, fields),) = model.items()
        t = _EARTH_VARIANTS.index(name)
        w.u32(t)
        for f in _EARTH_FIELDS[t]:
            if f not in fields and f == "projection_radius":
                # EarthModel.to_config emits the reference serde spelling
                f = "proj_radius"
            w.f64(fields[f])
    w.b += params.get("env_raw", b"")
    w.boolean(params.get("straight_rays", False))
    w.f64(params.get("simulation_step", 50.0))
    _write_output(w, params["output"])

    valid = np.asarray(hits.valid)
    height, width, _k = valid.shape
    lat0 = view["position"]["latitude"]
    lon0 = view["position"]["longitude"]
    dlat = np.asarray(hits.dlat, np.float64)
    dlon = np.asarray(hits.dlon, np.float64)
    elev_a = np.asarray(elev, np.float64).reshape(height, width)
    az_a = np.asarray(az, np.float64).reshape(height, width)
    dist_a = np.asarray(hits.distance, np.float64)
    el_a = np.asarray(hits.elevation, np.float64)
    plen_a = np.asarray(hits.path_length, np.float64)
    nrm_a = np.asarray(hits.normal, np.float64)
    kind_a = np.asarray(hits.kind)
    rgba_a = np.asarray(hits.rgba, np.float64)
    # Mirror the decoder's run vectorization: sky pixels and
    # single-terrain-hit pixels are bulk-encoded as structured arrays
    # (bit-identical bytes to the scalar writer); everything else falls
    # back to the per-pixel path.
    counts = valid.sum(axis=-1)
    cls1 = (counts == 1) & valid[:, :, 0] & (kind_a[:, :, 0] == 0)
    clsid = np.where(counts == 0, 0, np.where(cls1, 1, 2)).astype(np.int8)
    dt1 = _tp1_terrain_dtype(vec3_prefixed)
    w.u64(height)
    for i in range(height):
        w.u64(width)
        row_cls = clsid[i]
        bounds = np.flatnonzero(np.diff(row_cls)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [width]))
        for a, b in zip(starts, ends):
            c = int(row_cls[a])
            if c == 0:
                rec = np.empty(b - a, _HDR_DT)
                rec["elev"] = elev_a[i, a:b]
                rec["az"] = az_a[i, a:b]
                rec["n"] = 0
                w.b += rec.tobytes()
            elif c == 1:
                rec = np.empty(b - a, dt1)
                rec["elev"] = elev_a[i, a:b]
                rec["az"] = az_a[i, a:b]
                rec["n"] = 1
                rec["lat"] = lat0 + dlat[i, a:b, 0]
                rec["lon"] = lon0 + dlon[i, a:b, 0]
                rec["dist"] = dist_a[i, a:b, 0]
                rec["el"] = el_a[i, a:b, 0]
                rec["plen"] = plen_a[i, a:b, 0]
                if vec3_prefixed:
                    rec["v3len"] = 3
                rec["nx"] = nrm_a[i, a:b, 0, 0]
                rec["ny"] = nrm_a[i, a:b, 0, 1]
                rec["nz"] = nrm_a[i, a:b, 0, 2]
                rec["ctag"] = 0
                rec["alpha"] = rgba_a[i, a:b, 0, 3]
                w.b += rec.tobytes()
            else:
                for j in range(a, b):
                    w.f64(elev_a[i, j])
                    w.f64(az_a[i, j])
                    slots = np.nonzero(valid[i, j])[0]
                    w.u64(len(slots))
                    for s in slots:
                        w.f64(lat0 + dlat[i, j, s])
                        w.f64(lon0 + dlon[i, j, s])
                        w.f64(dist_a[i, j, s])
                        w.f64(el_a[i, j, s])
                        w.f64(plen_a[i, j, s])
                        w.vector3(nrm_a[i, j, s])
                        if int(kind_a[i, j, s]) == 0:
                            w.u32(0)
                            w.f64(rgba_a[i, j, s, 3])
                        else:
                            w.u32(1)
                            for cch in range(4):
                                w.f64(rgba_a[i, j, s, cch])
    raw = bytes(w.b)
    # mtime=0: a deterministic gzip header makes write→write bit-stable
    # (the libflate encoder the reference uses also emits no timestamp)
    return gzip.compress(raw, mtime=0) if compress else raw
