"""Scene objects: frustum + billboard intersection, culling, hit merging.

Counterpart of ``atm_raytracer_tpu/ops/objects.py``. Re-implements the
reference's ``Object`` trait (src/object/mod.rs:217-226) and its two impls —
analytic segment-vs-cone-frustum (src/object/frustum.rs) and textured
billboard (src/object/billboard.rs) — as dense segment tests over culled
candidate windows.

Reference control flow being replaced: per terrain point, ``objects_close``
collects the objects whose cartesian distance² < 2·(r+step)²
(frustum.rs:103-114, billboard.rs:68-78, gathered in utils.rs:71-89); per
march segment, each close object's ``check_collision`` runs on the segment
endpoints (utils.rs:241-279). Here each object gets a column window and a
window of march segments around its culling region, every (ray × window
segment) test runs at once, and each pixel keeps its earliest hits:

* ``object_col_windows`` — per object, the azimuth columns whose geodesic
  passes within its culling radius, planned from the model's own float64
  geodesics as tensors on the objects' device (one [n, 2] copy to the
  host), so the candidate tensors are [H, W_window, seg_window];
* ``apply_objects_planes`` — the separable grids (Fast, the Interpolating
  grid): one object at a time, in object order, merged into its column
  window of the frame's hit planes. CUDA tensors launch the kernel
  ``csrc/object_pass.cu`` (K6) once; CPU tensors, and ``plain=True``, run
  ``apply_objects_planes_plain``, K6's oracle on the card
  (``object_column_tables`` is the plain version of K6's prologue);
* ``object_hits_pixelwise`` + ``merge_hits`` — P independent rays
  (Rectilinear).

Geometry runs in each object's local ENU frame (``EarthModel.enu_rel``):
mm-accurate in float32 within culling radii, and the frame's up vector IS
the reference's ``v = world_directions(...).2`` (frustum.rs:31-34). Normals
rotate back to global cartesian with the object's host-built basis.

Every stage but K6 is plain PyTorch on the device of its inputs. The
object parameters are device tensors, so each quotient that decides a
hit's validity divides by a tensor: the card computes a division by a
Python float as a product with its float32 reciprocal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from .. import _kernels, tracing
from ..generators.base import HitBuffer
from ..models.earth import EarthModel
from ..physics.ray import DEATH_ALTITUDE, _f32
from .combine import NO_HIT, gather_column_field, gather_ray_field, k_smallest

# the per-object tensors of an ObjectSet, in the JAX ObjectSet's field order
ARRAY_FIELDS = ("kind", "dlat", "dlon", "elev", "r1", "r2", "height", "width",
                "rgba", "basis", "tex_id", "textures", "tex_hw", "cull_r2")

# the payload channels of a hit-plane set, in order: a set of planes is
# (key [H, W, K], vals [len(PLANE_CHANNELS), H, W, K])
PLANE_CHANNELS = ("dlat", "dlon", "distance", "elevation", "path_length", "kind",
                  "nx", "ny", "nz", "cr", "cg", "cb", "ca")


@dataclasses.dataclass
class ObjectSet:
    """Per-object tensors on one device, and the host metadata that plans
    the column windows."""

    kind: torch.Tensor  # [n] int32: 0 frustum, 1 billboard
    dlat: torch.Tensor  # [n] f32 relative to observer
    dlon: torch.Tensor
    elev: torch.Tensor  # [n] absolute altitude of the object base
    r1: torch.Tensor
    r2: torch.Tensor
    height: torch.Tensor
    width: torch.Tensor
    rgba: torch.Tensor  # [n, 4]
    basis: torch.Tensor  # [n, 3, 3] rows = (east, north, up) global cartesian
    tex_id: torch.Tensor  # [n] int32, -1 = untextured
    textures: torch.Tensor  # [T, TH, TW, 4] f32 atlas (T ≥ 1)
    tex_hw: torch.Tensor  # [T, 2] f32 true (h, w) of each texture
    cull_r2: torch.Tensor  # [n] culling radius², includes sim step
    n_objects: int
    seg_window: int  # march-steps window (covers the culling chord)
    kinds_static: tuple  # per-object kind on the host
    # per object (lat, lon, elev, cull_radius_m), host floats
    host_meta: tuple = ()

    @staticmethod
    def from_arrays(arrays: dict, *, seg_window: int, host_meta: tuple,
                    device) -> "ObjectSet":
        """An ObjectSet from host arrays named as ``ARRAY_FIELDS``."""
        tensors = {}
        for name in ARRAY_FIELDS:
            a = np.asarray(arrays[name])
            dtype = np.int32 if name in ("kind", "tex_id") else np.float32
            tensors[name] = torch.tensor(a.astype(dtype), device=device)
        kinds = tuple(int(k) for k in np.asarray(arrays["kind"]))
        return ObjectSet(**tensors, n_objects=len(kinds), seg_window=int(seg_window),
                         kinds_static=kinds, host_meta=tuple(host_meta))

    @staticmethod
    def build(params, device) -> Optional["ObjectSet"]:
        """The scene's objects (``Params.objects``) on ``device``; None
        when there are none."""
        objs = params.objects
        if not objs:
            return None
        lat0 = params.view.position.latitude
        lon0 = params.view.position.longitude
        step = params.simulation_step
        n = len(objs)
        a = {
            "kind": np.zeros(n, np.int32),
            "dlat": np.zeros(n, np.float32),
            "dlon": np.zeros(n, np.float32),
            "elev": np.zeros(n, np.float32),
            "r1": np.zeros(n, np.float32),
            "r2": np.zeros(n, np.float32),
            "height": np.zeros(n, np.float32),
            "width": np.zeros(n, np.float32),
            "rgba": np.zeros((n, 4), np.float32),
            "basis": np.zeros((n, 3, 3), np.float32),
            "tex_id": np.full(n, -1, np.int32),
            "cull_r2": np.zeros(n, np.float32),
        }
        textures: List[np.ndarray] = []
        for i, o in enumerate(objs):
            a["kind"][i] = 0 if o.kind == "Frustum" else 1
            a["dlat"][i] = o.lat - lat0
            a["dlon"][i] = o.lon - lon0
            a["elev"][i] = o.elev
            a["r1"][i], a["r2"][i] = o.r1, o.r2
            a["height"][i] = o.height
            a["width"][i] = o.width
            a["rgba"][i] = (o.color.r, o.color.g, o.color.b, o.color.a)
            north, east, up = params.model.world_directions(o.lat, o.lon)
            a["basis"][i] = np.stack([east, north, up])
            if o.kind == "Frustum":
                r = max(o.r1, o.r2)
                a["cull_r2"][i] = 2.0 * (r + step) ** 2  # frustum.rs:113
            else:
                a["cull_r2"][i] = 2.0 * (o.width + step) ** 2  # billboard.rs:77
            if o.texture is not None:
                a["tex_id"][i] = len(textures)
                textures.append(o.texture.astype(np.float32))
        if textures:
            th = max(t.shape[0] for t in textures)
            tw = max(t.shape[1] for t in textures)
            a["textures"] = np.zeros((len(textures), th, tw, 4), np.float32)
            a["tex_hw"] = np.zeros((len(textures), 2), np.float32)
            for t_i, t in enumerate(textures):
                a["textures"][t_i, : t.shape[0], : t.shape[1]] = t
                a["tex_hw"][t_i] = (t.shape[0], t.shape[1])
        else:
            a["textures"] = np.zeros((1, 2, 2, 4), np.float32)
            a["tex_hw"] = np.ones((1, 2), np.float32) * 2
        # window of march segments covering the culling chord: the close
        # region along a ray is at most 2·cull_radius long. The cap only
        # bounds candidate-tensor memory for giants (>12 km culling radius
        # at 50 m steps); within it the window covers the full chord — the
        # reference tests every close segment (utils.rs:241-250)
        max_chord = 2.0 * math.sqrt(float(a["cull_r2"].max()))
        want = max(4, math.ceil(max_chord / step) + 3)
        seg_window = int(min(512, want))
        if want > seg_window:
            print(
                f"WARNING: object culling window truncated to {seg_window} "
                f"of {want} march steps — intersections beyond "
                f"{seg_window * step:.0f} m into the culling region of the "
                "largest object will be missed"
            )
        host_meta = tuple(
            (float(o.lat), float(o.lon), float(o.elev), float(math.sqrt(a["cull_r2"][i])))
            for i, o in enumerate(objs)
        )
        return ObjectSet.from_arrays(a, seg_window=seg_window, host_meta=host_meta,
                                     device=device)


def ray_death_index(ray_h: torch.Tensor) -> torch.Tensor:
    """First sub-DEATH_ALTITUDE march index per ray, n_path if none ([H] f32).

    Segment k participates in object tests iff k <= this index — the
    reference's path cache ends one element after the first dead sample
    (utils.rs:159-171), so its object loop never sees later segments.
    """
    n_path = ray_h.shape[1]
    dead = ray_h < DEATH_ALTITUDE
    first = torch.argmax(dead.to(torch.uint8), dim=1)  # the first maximum
    return torch.where(dead.any(dim=1), first, n_path).to(torch.float32)


# the window scan's largest float64 temporary, [W·D, chunk of objects]:
# 128 MiB is 4 objects at 1080p over 200 km in 50 m steps (W·D = 1920·2000)
_WINDOW_SCAN_BYTES = 1 << 27


def object_col_windows(objects: ObjectSet, model: EarthModel, lat0: float, lon0: float,
                       az_deg, step: float, n_terr: int, stride: int = 2,
                       pad: int = 2) -> tuple:
    """Per-object azimuth-column windows for the separable generators.

    For each object, the columns whose geodesic ray passes within its culling
    radius (``is_close``, frustum.rs:103-114) — outside them no ray can hit
    it. The model's own float64 geodesics (``coords_at_dist_host``) at
    ``stride`` march steps along the ray, evaluated as float64 tensors on the
    objects' device, widened by the between-sample movement (stride·step)
    plus ``pad`` columns: conservative for every earth model. Only each
    object's first and last close column come back to the host.

    Returns a tuple of (col_lo, n_cols) per object; n_cols = 0 means the
    object is out of view for this azimuth grid.
    """
    with tracing.span("objects.col_windows"):
        f64 = dict(dtype=torch.float64, device=objects.kind.device)
        az = torch.as_tensor(az_deg, **f64)
        w = az.shape[0]
        dists = torch.arange(1, max(n_terr, 2), stride, **f64) * step  # [D]
        glat, glon = model.coords_at_dist_host(lat0, lon0, az[:, None], dists[None, :])
        # cartesian at elevation 0: raising both the geodesic point and the
        # object by the object's altitude moves their separation by at most
        # |p−c|·elev/R, negligible at culling-radius scales (see the margin)
        p = model.as_cartesian(glat, glon, torch.zeros_like(glat))  # [W, D, 3]
        del glat, glon
        meta = torch.tensor([(m[0], m[1], m[3]) for m in objects.host_meta], **f64)
        c = model.as_cartesian(meta[:, 0], meta[:, 1], torch.zeros_like(meta[:, 0]))  # [n, 3]
        # [n, W] min distance² over D via |p|² + |c|² − 2 p·c, a chunk of
        # objects at a time so that each [W·D, chunk] temporary stays under
        # _WINDOW_SCAN_BYTES whatever the number of objects
        p2 = (p * p).sum(-1).reshape(-1, 1)  # [W·D, 1]
        c2 = (c * c).sum(-1)  # [n]
        p = p.reshape(-1, 1, 3)
        chunk = max(1, _WINDOW_SCAN_BYTES // (8 * p2.shape[0]))
        d2 = []
        for i in range(0, c.shape[0], chunk):
            # elementwise, not a matmul: a first cuBLAS call would keep its
            # workspace allocated for the rest of the process
            pc = _dot(p, c[i:i + chunk])  # [W·D, chunk]
            d2.append((p2 + c2[None, i:i + chunk] - 2.0 * pc).reshape(w, -1, pc.shape[1])
                      .amin(dim=1).T)
            del pc
        del p
        d2 = torch.cat(d2)  # [n, W]
        rr = meta[:, 2] + stride * step + 1.0
        close = d2 < (rr * rr)[:, None]  # [n, W]
        cols = torch.arange(w, device=close.device)
        ends = torch.stack([torch.where(close, cols, w).amin(dim=1),
                            torch.where(close, cols, -1).amax(dim=1)], dim=1)
        windows = []
        for first, last in ends.tolist():  # the one copy to the host
            if last < 0:
                windows.append((0, 0))
                continue
            lo = max(0, first - pad)
            hi = min(w - 1, last + pad)
            windows.append((lo, hi - lo + 1))
        return tuple(windows)


def max_window_overlap(col_windows, n_objects: int) -> int:
    """Deepest column-window overlap: the most objects any single azimuth
    column can see, which bounds the per-pixel object-hit depth."""
    if col_windows is None:
        return n_objects
    events = []
    for lo, wn in col_windows:
        if wn:
            events.append((lo, 1))
            events.append((lo + wn, -1))
    deepest = cur = 0
    for _, delta in sorted(events):
        cur += delta
        deepest = max(deepest, cur)
    return deepest


# -- the intersection primitives ----------------------------------------------


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (3) of a·b, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _sample_texture(textures, tex_hw, tex_id, u, v):
    """Bilinear RGBA texture sample (object/mod.rs:89-118).

    u ∈ [0,1] across width, v ∈ [0,1] bottom→top; image rows are top-first.
    """
    t = tex_id.clamp(min=0)
    th = tex_hw[t, 0]
    tw = tex_hw[t, 1]
    zero = torch.zeros_like(th)
    x = u * tw - 0.5
    x1 = torch.minimum(torch.maximum(torch.floor(x), zero), tw - 2.0)
    y = (1.0 - v) * th - 0.5
    y1 = torch.minimum(torch.maximum(torch.floor(y), zero), th - 2.0)
    px = (x - x1)[..., None]
    py = (y - y1)[..., None]
    _, hh, ww, _ = textures.shape
    flat = textures.reshape(-1, 4)
    base = t.to(torch.int64) * (hh * ww) + y1.to(torch.int64) * ww + x1.to(torch.int64)
    # a non-finite (u, v) belongs to an invalid segment: keep its index in range
    base = base.clamp(0, flat.shape[0] - ww - 2)
    p00 = flat[base]
    p01 = flat[base + ww]
    p10 = flat[base + 1]
    p11 = flat[base + ww + 1]
    return (p00 * (1 - px) * (1 - py) + p01 * (1 - px) * py
            + p10 * px * (1 - py) + p11 * px * py)


def _frustum_hits(p1, p2, r1, r2, height):
    """Segment-vs-frustum (frustum.rs:17-101) in the object frame (v = ẑ).

    p1, p2: [..., 3]. Returns (props [..., 4], normals [..., 4, 3],
    valid [..., 4]): two side roots + bottom/top caps.
    """
    up = p1.new_tensor([0.0, 0.0, 1.0])
    w = p2 - p1
    wsq = _dot(w, w)
    p1sq = _dot(p1, p1)
    p1v = p1[..., 2]
    p1w = _dot(p1, w)
    wv = w[..., 2]
    aa = (r2 - r1) / height
    aa1 = 1.0 + aa * aa
    a = wsq - wv * wv * aa1
    b = 2.0 * (p1w - wv * (p1v * aa1 + aa * r1))
    c = p1sq - p1v * p1v * aa1 - r1 * r1 - 2.0 * aa * r1 * p1v
    delta = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(delta, min=0.0))
    safe_a = torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    x1 = (-b - sq) / (2.0 * safe_a)
    x2 = (-b + sq) / (2.0 * safe_a)
    lo = torch.where(a < 0.0, x2, x1)  # frustum.rs:56
    hi = torch.where(a < 0.0, x1, x2)
    ang = torch.atan2(r1 - r2, height)
    cos_ang, sin_ang = torch.cos(ang), torch.sin(ang)

    def side(x):
        inter = p1 + w * x[..., None]
        h = inter[..., 2]
        ok = (delta >= 0.0) & (x >= 0.0) & (x < 1.0) & (h >= 0.0) & (h < height)
        outward = inter - h[..., None] * up
        olen = torch.sqrt(_dot(outward, outward))
        outward = outward / torch.clamp(olen, min=1e-30)[..., None]
        return x, outward * cos_ang + up * sin_ang, ok

    def cap(h_cap, r_cap, n_sign: float):
        safe_wv = torch.where(torch.abs(wv) < 1e-12, 1e-12, wv)
        x = (h_cap - p1v) / safe_wv
        out = p1 + w * x[..., None] - h_cap * up
        ok = (_dot(out, out) < r_cap * r_cap) & (x >= 0.0) & (x < 1.0)
        return x, (up * n_sign).expand(out.shape), ok

    xs1, n1, ok1 = side(lo)
    xs2, n2, ok2 = side(hi)
    xc1, nc1, okc1 = cap(torch.zeros_like(height), r1, -1.0)
    xc2, nc2, okc2 = cap(height, r2, 1.0)
    props = torch.stack([xs1, xs2, xc1, xc2], dim=-1)
    normals = torch.stack([n1, n2, nc1, nc2], dim=-2)
    valid = torch.stack([ok1, ok2, okc1, okc2], dim=-1)
    return props, normals, valid


def _billboard_hit(p1, p2, width, height):
    """Segment-vs-billboard (billboard.rs:17-66): an upright rectangle always
    facing the ray. Returns (prop, normal [..., 3], u, v, valid)."""
    up = p1.new_tensor([0.0, 0.0, 1.0])
    ray = p2 - p1
    right = torch.linalg.cross(ray, up.expand(ray.shape), dim=-1)
    rlen = torch.sqrt(_dot(right, right))
    right = right / torch.clamp(rlen, min=1e-30)[..., None]
    front = torch.linalg.cross(right, up.expand(right.shape), dim=-1)
    denom = _dot(ray, front)
    safe = torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
    prop = -_dot(p1, front) / safe
    inter = p1 + ray * prop[..., None]
    y = inter[..., 2]
    x = _dot(inter, right)
    ok = ((prop >= 0.0) & (prop < 1.0) & (y >= 0.0) & (y < height)
          & (x >= -width / 2.0) & (x < width / 2.0))
    u = (x + width / 2.0) / width
    v = y / height
    return prop, front, u, v, ok


def _object_candidates(objects: ObjectSet, oi: int, p1, p2):
    """One object's sub-hits on the segments (p1, p2) [..., kw, 3] of its
    frame: (props [..., kw, S], normals [..., kw, S, 3] in the object frame,
    rgba [..., kw, S, 4], valid [..., kw, S]); S = 4 for a frustum (two side
    roots, two caps), 1 for a billboard (textured where it has a texture)."""
    if objects.kinds_static[oi] == 0:
        props, normals_loc, valid = _frustum_hits(
            p1, p2, objects.r1[oi], objects.r2[oi], objects.height[oi])
        rgba = objects.rgba[oi].expand(props.shape + (4,))
        return props, normals_loc, rgba, valid
    prop, front, u, v, ok = _billboard_hit(p1, p2, objects.width[oi], objects.height[oi])
    texed = _sample_texture(objects.textures, objects.tex_hw, objects.tex_id[oi], u, v)
    rgba1 = torch.where(objects.tex_id[oi] >= 0, texed,
                        objects.rgba[oi].expand(texed.shape))
    return prop[..., None], front[..., None, :], rgba1[..., None, :], ok[..., None]


def _rotate(nloc, b):
    """Object-frame vectors [..., 3] (or their 3 channels) to global
    cartesian through the basis rows ``b`` [3, 3]: channel d is
    n0·b[0, d] + n1·b[1, d] + n2·b[2, d]."""
    return [nloc[0] * b[0, d] + nloc[1] * b[1, d] + nloc[2] * b[2, d] for d in range(3)]


# -- the separable grids: hit planes ------------------------------------------


def _object_window_planes(objects: ObjectSet, oi: int, model: EarthModel, lat0: float,
                          step: float, ray_h, path_len, dlat, dlon, k_per_object: int,
                          death_idx):
    """One object's hits over its column window of the separable grid.

    ray_h, path_len: [H, N]; dlat, dlon: [Wo, N] the window's terrain-scan
    geodesic; death_idx: ``ray_death_index(ray_h)``. Finds per column the
    first march step inside the culling radius (utils.rs:74-80), tests a
    window of ``seg_window`` segments from there for every row-ray, and
    keeps the ``k_per_object`` earliest hits per pixel as planes (key
    [H, Wo, k], vals [C, H, Wo, k]).
    """
    h_n, n_path = ray_h.shape
    w_n, n_t = dlat.shape
    kw = objects.seg_window
    dev = ray_h.device
    o_dlat, o_dlon, o_elev = objects.dlat[oi], objects.dlon[oi], objects.elev[oi]
    # culling: distance² of the terrain points at the object's altitude
    # (frustum.rs:103-114)
    rel = model.enu_rel(dlat, dlon, o_elev, o_dlat, o_dlon, o_elev, lat0)  # [Wo, N, 3]
    close = _dot(rel, rel) < objects.cull_r2[oi]  # [Wo, N]
    first_k = torch.where(close.any(dim=1), torch.argmax(close.to(torch.uint8), dim=1), n_t)
    # the window starts one step early: segment (k-1, k) also sees the
    # object through its far end (utils.rs:241-250 checks old OR new point)
    k_lo = torch.clamp(first_k - 1, 0, max(n_t - kw - 1, 0))  # [Wo]
    k_idx = torch.clamp(k_lo[:, None] + torch.arange(kw + 1, device=dev)[None, :],
                        max=n_t - 1)  # [Wo, kw+1]
    g_dlat = dlat.gather(1, k_idx)
    g_dlon = dlon.gather(1, k_idx)
    g_close = close.gather(1, k_idx)
    # the ray altitudes at the window steps: one index_select of ray_h's
    # columns, never a broadcast [H, W, N] cube
    rh = ray_h.index_select(1, k_idx.reshape(-1).clamp(max=n_path - 1)).reshape(
        h_n, w_n, kw + 1)
    p = model.enu_rel(g_dlat[None], g_dlon[None], rh, o_dlat, o_dlon, o_elev,
                      lat0)  # [H, Wo, kw+1, 3]
    # a segment is eligible if either end is close (utils.rs:241-250)
    seg_close = g_close[:, :-1] | g_close[:, 1:]  # [Wo, kw]
    seg_k = k_idx[:, :-1].to(torch.float32)  # [Wo, kw] global segment index
    # ray death (utils.rs:159-171): segment k participates iff k <= the
    # first-death index
    seg_alive = seg_k[None, :, :] <= death_idx[:, None, None]  # [H, Wo, kw]

    props, normals_loc, rgba, valid = _object_candidates(
        objects, oi, p[..., :-1, :], p[..., 1:, :])
    del p
    valid = valid & (seg_close[None, :, :] & seg_alive)[..., None]
    valid = valid & (rgba[..., 3] > 0.0)  # fully transparent texels (utils.rs:258-259)
    keys = torch.where(valid, seg_k[None, :, :, None] + torch.clamp(props, 0.0, 0.999999),
                       NO_HIT).reshape(h_n, w_n, -1)
    normals_flat = normals_loc.reshape(h_n, w_n, keys.shape[-1], 3)
    rgba_flat = rgba.reshape(h_n, w_n, keys.shape[-1], 4)
    del props, normals_loc, rgba, valid

    # the k earliest hits: successive masked mins, each slot's payload by an
    # equality one-hot; duplicate equal keys average, as in merge_hits
    b = objects.basis[oi]  # rows = (east, north, up) global cartesian
    f_step = _f32(step)
    fin = torch.isfinite(keys)
    out_key, out_vals = [], []
    cur = keys
    for k in range(k_per_object):
        m = cur.amin(dim=-1)  # [H, Wo]
        if k + 1 < k_per_object:
            cur = torch.where(cur <= m[..., None], NO_HIT, cur)
        vk = torch.isfinite(m)

        def z(x, vk=vk):
            return torch.where(vk, x, 0.0)

        eqf = ((keys == m[..., None]) & fin).to(torch.float32)
        inv_cnt = 1.0 / torch.clamp(eqf.sum(-1), min=1.0)
        nloc = [torch.sum(normals_flat[..., d] * eqf, -1) * inv_cnt for d in range(3)]
        safe = torch.where(vk, m, 0.0)
        ch = {
            "dlat": z(gather_column_field(dlat, safe)),
            "dlon": z(gather_column_field(dlon, safe)),
            "distance": safe * f_step,
            # TracePoint fields at the hit (utils.rs:261-273): lerped along
            # the march; elevation = the RAY's elevation
            "elevation": z(gather_ray_field(ray_h, safe)),
            "path_length": z(gather_ray_field(path_len, safe)),
            "kind": vk.to(torch.float32),
        }
        for nm, x in zip(("nx", "ny", "nz"), _rotate(nloc, b)):
            ch[nm] = z(x)
        for d, nm in enumerate(("cr", "cg", "cb", "ca")):
            ch[nm] = z(torch.sum(rgba_flat[..., d] * eqf, -1) * inv_cnt)
        out_key.append(torch.where(vk, m, NO_HIT))
        out_vals.append(torch.stack([ch[nm] for nm in PLANE_CHANNELS]))
    return torch.stack(out_key, dim=-1), torch.stack(out_vals, dim=-1)


def hits_to_planes(hits: HitBuffer):
    """A [H, W, K] hit buffer as K-slot planes: key +inf and every payload
    0 on invalid slots (the merge's equality one-hot matches every +inf
    key, so their payloads must be zero)."""
    v = hits.valid

    def z(x):
        return torch.where(v, x, 0.0)

    chans = {
        "dlat": hits.dlat, "dlon": hits.dlon, "distance": hits.distance,
        "elevation": hits.elevation, "path_length": hits.path_length,
        "kind": hits.kind.to(torch.float32),
        "nx": hits.normal[..., 0], "ny": hits.normal[..., 1], "nz": hits.normal[..., 2],
        "cr": hits.rgba[..., 0], "cg": hits.rgba[..., 1], "cb": hits.rgba[..., 2],
        "ca": hits.rgba[..., 3],
    }
    key = torch.where(v, hits.key, NO_HIT)
    return key, torch.stack([z(chans[nm]) for nm in PLANE_CHANNELS])


def planes_to_hits(key: torch.Tensor, vals: torch.Tensor) -> HitBuffer:
    """The HitBuffer of a plane set (key [..., K], vals [C, ..., K])."""
    ch = dict(zip(PLANE_CHANNELS, vals))
    return HitBuffer(
        valid=torch.isfinite(key),
        key=key,
        dlat=ch["dlat"],
        dlon=ch["dlon"],
        distance=ch["distance"],
        elevation=ch["elevation"],
        path_length=ch["path_length"],
        normal=torch.stack([ch["nx"], ch["ny"], ch["nz"]], dim=-1),
        kind=torch.round(ch["kind"]).to(torch.int32),
        rgba=torch.stack([ch["cr"], ch["cg"], ch["cb"], ch["ca"]], dim=-1),
    )


def _pad_planes(planes, k_out: int):
    """A new plane set: ``planes`` widened to k_out slots (new slots
    invalid, payload zero)."""
    key, vals = planes
    n_pad = k_out - key.shape[-1]
    if n_pad <= 0:
        return key.clone(), vals.clone()
    return (torch.nn.functional.pad(key, (0, n_pad), value=NO_HIT),
            torch.nn.functional.pad(vals, (0, n_pad)))


def _merge_planes(a, b, k_out: int):
    """The k_out earliest keys of two plane sets, with their payloads.

    The keys come from successive masked mins; slot s's payload is the sum
    over the inputs of value × (key == key_s), in input order, times one
    over the match count: equal keys average, and invalid slots (+inf, zero
    payload) contribute zero."""
    keys = torch.cat([a[0], b[0]], dim=-1)  # [..., Kc]
    vals = torch.cat([a[1], b[1]], dim=-1)  # [C, ..., Kc]
    sel = k_smallest(keys, k_out)  # [..., k_out]
    eq = (keys[..., None, :] == sel[..., :, None]).to(torch.float32)  # [..., k_out, Kc]
    count = eq[..., 0]
    for i in range(1, keys.shape[-1]):
        count = count + eq[..., i]
    inv_match = 1.0 / torch.clamp(count, min=1.0)  # [..., k_out]
    acc = vals[..., 0, None] * eq[..., 0]
    for i in range(1, keys.shape[-1]):
        acc = acc + vals[..., i, None] * eq[..., i]
    return sel, acc * inv_match


def apply_objects_planes(planes, objects: ObjectSet, model: EarthModel, lat0: float,
                         step: float, ray_h, path_len, dlat, dlon, col_windows,
                         k_out: int, k_per_object: int = 2, plain: bool = False):
    """Merge every object's hits into the frame's hit planes.

    planes: (key [H, W, K], vals [C, H, W, K]) of the terrain hits, K <=
    k_out; ray_h, path_len: [H, N]; dlat, dlon: [W, N]; col_windows:
    per-object (lo, n), or None for the full width. Returns new planes of
    ``k_out`` slots: each object, in object order, computes its
    ``k_per_object`` earliest hits over its column window and merges them
    into just that window (the semantics of the JAX package's
    ``_apply_objects_planes_unrolled``). Sequential merges keep the k_out
    earliest hits per pixel, so overlapping windows compose.

    CUDA tensors launch K6 (``object_pass_cuda``) or raise; CPU tensors,
    and ``plain=True`` on any device, run ``apply_objects_planes_plain``.
    """
    if col_windows is None:
        col_windows = ((0, dlat.shape[0]),) * objects.n_objects
    args = (planes, objects, model, lat0, step, ray_h, path_len, dlat, dlon, col_windows,
            k_out, k_per_object)
    with tracing.span("objects.pass", device=True):
        if plain or ray_h.device.type == "cpu":
            out = apply_objects_planes_plain(*args)
            tracing.count("objects.pass_launches", 0)
        elif ray_h.device.type == "cuda":
            out = object_pass_cuda(*args)
            tracing.count("objects.pass_launches", 1)
        else:
            raise ValueError(f"apply_objects_planes: unsupported device {ray_h.device}")
    return out


def apply_objects_planes_plain(planes, objects: ObjectSet, model: EarthModel, lat0: float,
                               step: float, ray_h, path_len, dlat, dlon, col_windows,
                               k_out: int, k_per_object: int = 2):
    """Plain PyTorch version of ``apply_objects_planes`` (``col_windows`` as
    a tuple): the planes widened to k_out, then per object its candidate
    tensors and k-min loop (``_object_window_planes``) and a one-hot merge
    into its window (``_merge_planes``)."""
    key, vals = _pad_planes(planes, k_out)
    death_idx = ray_death_index(ray_h)
    for oi in range(objects.n_objects):
        lo, wn = col_windows[oi]
        if wn == 0:
            continue
        win = slice(lo, lo + wn)
        obj = _object_window_planes(objects, oi, model, lat0, step, ray_h, path_len,
                                    dlat[win], dlon[win], k_per_object, death_idx)
        mk, mv = _merge_planes((key[:, win], vals[:, :, win]), obj, k_out)
        key[:, win] = mk
        vals[:, :, win] = mv
    return key, vals


@dataclasses.dataclass
class ColumnTables:
    """What K6 reads of each object's column window, built once a frame:
    one table column a window column, the objects' windows back to back
    in object order (C columns in all)."""

    windows: tuple  # per object (col_lo, n_cols, its first table column)
    k_lo: torch.Tensor  # [C] int32: the window's first march step
    # [kw+1, 3, C] f32: EarthModel.enu_terms at window step j, march step
    # min(k_lo + j, N - 1): the point's ENU at any ray altitude, no trig
    terms: torch.Tensor
    seg_close: torch.Tensor  # [kw, C] uint8: segment j has a close end


def _window_layout(col_windows) -> tuple:
    """Per object (col_lo, n_cols, first table column): the windows back to
    back."""
    out, off = [], 0
    for lo, wn in col_windows:
        out.append((lo, wn, off))
        off += wn
    return tuple(out)


def object_column_tables(objects: ObjectSet, model: EarthModel, lat0: float, dlat, dlon,
                         col_windows) -> ColumnTables:
    """Plain version of K6's prologue (its culling scan and window tables):
    for every window column, with ``_object_window_planes``'s arithmetic
    batched over the objects, the culling test at every march step (the
    distance² at the object's altitude against its cull radius²,
    frustum.rs:103-114), the window's first step (one before the first
    close step), the close flags of its segments, and the ENU terms of its
    points. dlat, dlon: [W, N]."""
    kw = objects.seg_window
    n_t = dlat.shape[1]
    dev = dlat.device
    windows = _window_layout(col_windows)
    live = [(oi, lo, wn) for oi, (lo, wn, _) in enumerate(windows) if wn]
    if not live:
        return ColumnTables(windows, torch.zeros(0, dtype=torch.int32, device=dev),
                            torch.zeros((kw + 1, 3, 0), device=dev),
                            torch.zeros((kw, 0), dtype=torch.uint8, device=dev))
    g_dlat = torch.cat([dlat[lo:lo + wn] for _, lo, wn in live])  # [C, N]
    g_dlon = torch.cat([dlon[lo:lo + wn] for _, lo, wn in live])
    per_obj = torch.stack([objects.dlat, objects.dlon, objects.elev, objects.cull_r2], dim=1)
    per_col = torch.cat([per_obj[oi].expand(wn, 4) for oi, _, wn in live])  # [C, 4]
    o_dlat, o_dlon, o_elev, cull_r2 = (per_col[:, i, None] for i in range(4))
    terms = model.enu_terms(g_dlat, g_dlon, o_dlat, o_dlon, lat0)
    del g_dlat, g_dlon
    rel = model.enu_from_terms(terms, o_elev, o_elev)
    close = _dot(rel, rel) < cull_r2  # [C, N]
    del rel
    first_k = torch.where(close.any(dim=1), torch.argmax(close.to(torch.uint8), dim=1), n_t)
    k_lo = torch.clamp(first_k - 1, 0, max(n_t - kw - 1, 0))  # [C]
    k_idx = torch.clamp(k_lo[:, None] + torch.arange(kw + 1, device=dev)[None, :],
                        max=n_t - 1)  # [C, kw+1]
    g_close = close.gather(1, k_idx)
    seg_close = (g_close[:, :-1] | g_close[:, 1:]).T.to(torch.uint8).contiguous()
    win_terms = torch.stack([t.gather(1, k_idx).T for t in terms], dim=1).contiguous()
    return ColumnTables(windows, k_lo.to(torch.int32), win_terms, seg_close)


def object_pass_cuda(planes, objects: ObjectSet, model: EarthModel, lat0: float,
                     step: float, ray_h, path_len, dlat, dlon, col_windows, k_out: int,
                     k_per_object: int = 2, *, tables_out: Optional[list] = None):
    """``apply_objects_planes`` on CUDA tensors: one launch of K6
    (csrc/object_pass.cu), which builds the per-column tables and writes the
    k_out planes of every pixel once. Returns (key, vals); a list given as
    ``tables_out`` receives the ``ColumnTables`` K6 built (its scratch)."""
    key_in, vals_in = planes
    h_n, w_n, k_in = key_in.shape
    if not 1 <= k_per_object <= 2:
        raise ValueError(f"K6 keeps 1 or 2 hits an object, got k_per_object={k_per_object}")
    if not 1 <= k_in <= k_out:
        raise ValueError(f"K6 widens {k_in} slots to k_out={k_out}: needs 1 <= K <= k_out")
    if h_n * w_n * k_out >= 2**31:
        raise ValueError(f"K6 indexes a plane in 32 bits: H·W·k_out = {h_n * w_n * k_out} "
                         "must stay under 2^31")
    dev = ray_h.device
    if any(x.device != dev for x in (key_in, vals_in, path_len, dlat, dlon, objects.kind)):
        raise ValueError("object_pass_cuda: the planes, rays, columns and objects must all "
                         f"live on {dev}")
    kw, n_t = objects.seg_window, dlat.shape[1]
    layout = _window_layout(col_windows)
    n_cols = sum(wn for _, wn, _ in layout)
    tables = ColumnTables(layout, torch.empty(n_cols, dtype=torch.int32, device=dev),
                          torch.empty((kw + 1, 3, n_cols), device=dev),
                          torch.empty((kw, n_cols), dtype=torch.uint8, device=dev))
    scan = torch.empty(n_cols, dtype=torch.int32, device=dev)
    death = ray_death_index(ray_h)
    # the windows as a device table, through pinned memory: no synchronization
    windows = torch.tensor(layout, dtype=torch.int32).pin_memory().to(dev, non_blocking=True)
    key_out = torch.empty((h_n, w_n, k_out), dtype=torch.float32, device=dev)
    vals_out = torch.empty((len(PLANE_CHANNELS), h_n, w_n, k_out), dtype=torch.float32,
                           device=dev)
    key_in, vals_in, ray_h, path_len, dlat, dlon = (
        x.to(torch.float32).contiguous() for x in (key_in, vals_in, ray_h, path_len, dlat, dlon))
    radius = model.enu_radius()
    o = objects
    _, tex_h, tex_w, _ = o.textures.shape
    arrays = [x.contiguous() for x in (o.kind, o.dlat, o.dlon, o.elev, o.cull_r2, o.r1, o.r2,
                                       o.height, o.width, o.rgba, o.basis, o.tex_id,
                                       o.textures, o.tex_hw)]
    _kernels.OBJECT_PASS.call(
        dev, key_in.data_ptr(), vals_in.data_ptr(), k_in, key_out.data_ptr(),
        vals_out.data_ptr(), int(k_out), h_n, w_n, ray_h.data_ptr(), path_len.data_ptr(),
        ray_h.shape[1], dlat.data_ptr(), dlon.data_ptr(), n_t, death.data_ptr(),
        windows.data_ptr(), o.n_objects, n_cols, kw, scan.data_ptr(), tables.k_lo.data_ptr(),
        tables.terms.data_ptr(), tables.seg_close.data_ptr(),
        *(x.data_ptr() for x in arrays), o.textures.shape[0], tex_h, tex_w, float(lat0),
        0.0 if radius is None else float(radius), int(radius is None), _f32(step),
        int(k_per_object),
    )
    if tables_out is not None:
        tables_out.append(tables)
    return key_out, vals_out


# -- P independent rays (Rectilinear) -----------------------------------------


def object_hits_pixelwise(objects: ObjectSet, model: EarthModel, lat0: float,
                          lon0: float, step: float, n_terr: int, ray_h, path_len,
                          dir_deg, k_per_object: int = 2) -> HitBuffer:
    """Object hits for P independent rays (the Rectilinear generator).

    ray_h, path_len: [P, n_terr]; dir_deg: [P] each ray's azimuth. Each
    ray owns its geodesic: a coarse distance scan at 4 march steps finds
    where the culling region starts (with a stride·step margin, so a stride
    cannot step over it), then ``seg_window + 2·stride + 2`` segments are
    tested exactly. Returns the per-object hits concatenated along the slot
    axis, unordered ([P, n·k]); the caller's ``merge_hits`` orders them.
    """
    p_n = ray_h.shape[0]
    dev = ray_h.device
    stride = 4
    # the coarse scan can flag up to the margin before the true close
    # region, so the exact window spans the margin on both sides plus the
    # close-region chord
    kw = objects.seg_window + 2 * stride + 2
    f_step = _f32(step)
    dir_col = dir_deg[:, None]
    # the object-independent coarse geodesic: one evaluation for the scene
    n_coarse = -(-n_terr // stride)
    dists_c = (torch.arange(n_coarse, dtype=torch.float32, device=dev) * stride) * f_step
    dl_c, dn_c = model.geodesic_delta(lat0, lon0, dir_col, dists_c[None, :])
    death_idx = ray_death_index(ray_h)  # [P]
    offs = torch.arange(kw + 1, device=dev)
    margin = _f32(stride * step)

    parts = []
    for oi in range(objects.n_objects):
        o_dlat, o_dlon, o_elev = objects.dlat[oi], objects.dlon[oi], objects.elev[oi]
        rel_c = model.enu_rel(dl_c, dn_c, o_elev, o_dlat, o_dlon, o_elev, lat0)
        d2_c = rel_c[..., 0] ** 2 + rel_c[..., 1] ** 2 + rel_c[..., 2] ** 2
        close_c = d2_c < (torch.sqrt(objects.cull_r2[oi]) + margin) ** 2
        del rel_c, d2_c
        first_c = torch.where(close_c.any(dim=1),
                              torch.argmax(close_c.to(torch.uint8), dim=1), n_coarse)
        k_lo = torch.clamp(first_c * stride - stride - 1, 0, max(n_terr - kw - 1, 0))
        k_idx = torch.clamp(k_lo[:, None] + offs[None, :], max=n_terr - 1)  # [P, kw+1]
        dl_w, dn_w = model.geodesic_delta(lat0, lon0, dir_col,
                                          k_idx.to(torch.float32) * f_step)
        rh = ray_h.gather(1, k_idx)  # [P, kw+1]
        p = model.enu_rel(dl_w, dn_w, rh, o_dlat, o_dlon, o_elev, lat0)
        # exact culling at the window points (the terrain-point test at the
        # object's elevation)
        rel_w = model.enu_rel(dl_w, dn_w, o_elev, o_dlat, o_dlon, o_elev, lat0)
        g_close = _dot(rel_w, rel_w) < objects.cull_r2[oi]
        seg_close = g_close[..., :-1] | g_close[..., 1:]
        seg_k = k_idx[:, :-1].to(torch.float32)

        props, normals_loc, rgba, valid = _object_candidates(
            objects, oi, p[..., :-1, :], p[..., 1:, :])
        seg_alive = seg_k <= death_idx[:, None]  # [P, kw]
        valid = valid & (seg_close & seg_alive)[..., None] & (rgba[..., 3] > 0.0)
        keys = torch.where(valid, seg_k[..., None] + torch.clamp(props, 0.0, 0.999999),
                           NO_HIT).reshape(p_n, -1)
        neg_top, top_idx = torch.topk(-keys, k_per_object, dim=-1)
        sel_keys = -neg_top
        flat_n = keys.shape[-1]
        sel_norm_loc = normals_loc.reshape(p_n, flat_n, 3).gather(
            1, top_idx[..., None].expand(-1, -1, 3))
        sel_rgba = rgba.reshape(p_n, flat_n, 4).gather(
            1, top_idx[..., None].expand(-1, -1, 4))
        sel_valid = torch.isfinite(sel_keys)
        sel_norm = torch.stack(
            _rotate([sel_norm_loc[..., c] for c in range(3)], objects.basis[oi]), dim=-1)

        safe = torch.where(sel_valid, sel_keys, 0.0)
        kk = torch.floor(safe)
        pp = safe - kk
        dl1, dn1 = model.geodesic_delta(lat0, lon0, dir_col, kk * f_step)
        dl2, dn2 = model.geodesic_delta(lat0, lon0, dir_col, (kk + 1.0) * f_step)
        parts.append(HitBuffer(
            valid=sel_valid,
            key=sel_keys,
            dlat=dl1 * (1 - pp) + dl2 * pp,
            dlon=dn1 * (1 - pp) + dn2 * pp,
            distance=safe * f_step,
            elevation=gather_ray_field(ray_h, safe),
            path_length=gather_ray_field(path_len, safe),
            normal=sel_norm,
            kind=torch.ones(sel_keys.shape, dtype=torch.int32, device=dev),
            rgba=sel_rgba,
        ))
    return concat_hits(parts)


def concat_hits(parts) -> HitBuffer:
    """Concatenate hit buffers along the slot axis (no ordering)."""
    axis = parts[0].valid.ndim - 1
    return HitBuffer(**{
        f.name: torch.cat([getattr(p, f.name) for p in parts], dim=axis)
        for f in dataclasses.fields(HitBuffer)
    })


def merge_hits(a: HitBuffer, b: HitBuffer, k_out: int) -> HitBuffer:
    """Merge two hit buffers [..., K(, D)] and keep the k_out earliest by key.

    The keys come from successive masked mins (``k_smallest``; inputs need
    not be sorted), and each payload field re-pairs through the equality
    one-hot: the sum over the inputs of value × match, in input order,
    over the match count. Duplicate finite keys average; the +inf slots
    match every invalid input, whose payloads they average (so compare
    merged buffers on their valid slots only).
    """
    def cat(x, y):
        return torch.cat([x, y], dim=a.valid.ndim - 1)

    keys_all = torch.where(cat(a.valid, b.valid), cat(a.key, b.key), NO_HIT)
    skeys = k_smallest(keys_all, k_out)  # [..., k_out]
    oh = (keys_all[..., None, :] == skeys[..., :, None]).to(torch.float32)
    n_all = keys_all.shape[-1]
    matches = oh[..., 0]
    for i in range(1, n_all):
        matches = matches + oh[..., i]
    matches = torch.clamp(matches, min=1.0)

    def pick(x):  # x [..., K_all]
        acc = x[..., None, 0] * oh[..., 0]
        for i in range(1, n_all):
            acc = acc + x[..., None, i] * oh[..., i]
        return acc / matches

    def pick_vec(xa, xb):
        x = cat(xa, xb)
        return torch.stack([pick(x[..., d]) for d in range(x.shape[-1])], dim=-1)

    return HitBuffer(
        valid=torch.isfinite(skeys),
        key=skeys,
        dlat=pick(cat(a.dlat, b.dlat)),
        dlon=pick(cat(a.dlon, b.dlon)),
        distance=pick(cat(a.distance, b.distance)),
        elevation=pick(cat(a.elevation, b.elevation)),
        path_length=pick(cat(a.path_length, b.path_length)),
        normal=pick_vec(a.normal, b.normal),
        kind=torch.round(pick(cat(a.kind, b.kind).to(torch.float32))).to(torch.int32),
        rgba=pick_vec(a.rgba, b.rgba),
    )
