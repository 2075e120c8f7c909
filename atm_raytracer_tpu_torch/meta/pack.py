"""Device-side packing of frames and viewer metadata for the trip to the host.

Counterpart of ``atm_raytracer_tpu/meta/pack.py``, with its names, its
payload bytes and its host decoders. Each ``@jax.jit`` function there is a
plain function on tensors here: it runs where its inputs live, and the
decoding runs on the host in numpy.

* ``pack_frame_stream`` / ``pack_frame_compact``: the lossless frame codec.
  Pixels with no valid slot are the frame's constant no-hit color
  (``frame_base_rgb``), so only hit pixels ship, as per-channel 4-bit
  stream deltas behind a u32 validity bitmask, with an exact exception
  side channel for larger deltas. ``pack_frame_stream`` has static shapes
  and makes no host sync; ``pack_frame_compact`` is its uncapped form and
  also takes a leading frame axis (a sweep's frames in one call). No
  render of the port calls them: its banded render fetches each band raw,
  which an H100 does faster than the codec's launches and host decode.
* ``pack_viewer_fields``: the viewer's key / dlat / dlon / elevation in
  14 B a slot (key exact, lat/lon range-coded to 2^24 levels, elevation to
  u16); ``pack_viewer_fields_separable``: key and elevation of the valid
  slots only, lat/lon derived on the host in f64; ``pack_viewer_fields_delta``:
  that payload delta-coded, plus the frame. The ``fetch_*`` functions run a
  pack and bring its segments to the host through ``generators.base``.

Compaction without a sync: a cumsum of the valid positions and a scatter
into a buffer one longer than the stream, whose last slot takes every
invalid entry (JAX's ``mode="drop"``), then a slice. PyTorch's CUDA support
for uint16 and uint32 is thin, so the codes are built in int32 / int64 and
narrowed on the device to the signed type of the same width with the same
bits (``_narrow``): u32 words travel as int32, u16 elevation codes as int16,
and the host views them as u32 / u16 (``_u32``, ``_u16``). The u8 nibbles
and i8 key deltas narrow on the device directly. The bytes equal the JAX
segments' bytes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

if hasattr(np, "bitwise_count"):
    _popcount = np.bitwise_count
else:  # NumPy < 2.0: unpackbits fallback
    def _popcount(a):
        arr = np.atleast_1d(np.ascontiguousarray(a, dtype=np.uint32))
        bits = np.unpackbits(arr.view(np.uint8)).reshape(arr.size, 32)
        return bits.sum(axis=-1, dtype=np.int64).reshape(np.shape(a))

_LEVELS = float(1 << 24)  # usable quantization levels (f32-round bounded)
_BIG = 3.4e38  # the f32 sentinel of the masked min / max


# -- device helpers -------------------------------------------------------------

def _narrow(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned values of ``bits`` bits (in a wider int) as the signed type of
    that width with the same bits: the host views them as unsigned."""
    dtype = {16: torch.int16, 32: torch.int32}[bits]
    return torch.where(x >= 2 ** (bits - 1), x - 2 ** bits, x).to(dtype)


def _u32(a) -> np.ndarray:
    """A host segment of u32 words (fetched as int32 bits) as uint32."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else np.asarray(a, np.uint32)


def _u16(a) -> np.ndarray:
    """A host segment of u16 codes (fetched as int16 bits) as uint16."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint16) if a.dtype == np.int16 else np.asarray(a, np.uint16)


def _range_code(v, lo, hi, levels):
    """round((v - lo)·(levels - 1)/max(hi - lo, 1e-30)) as int32: JAX's u32
    code, whose values lie in [0, levels - 1]. The numerator is a float32
    tensor: PyTorch computes ``scalar / tensor`` as a reciprocal times the
    scalar, JAX as a division."""
    num = torch.full((), levels - 1.0, dtype=torch.float32, device=v.device)
    scale = num / torch.clamp(hi - lo, min=1e-30)
    return torch.round((v - lo) * scale).to(torch.int32)


def _masked_range(v, valid):
    """(lo, hi) of ``v`` over the valid slots, (0, 0) when there are none."""
    lo = torch.where(valid, v, _BIG).min()
    hi = torch.where(valid, v, -_BIG).max()
    ok = valid.any()
    return torch.where(ok, lo, 0.0), torch.where(ok, hi, 0.0)


def _bitmask(v: torch.Tensor) -> torch.Tensor:
    """The validity bitmask of bool ``v`` [..., P]: int32 words [...,
    ceil(P/32)] carrying the u32 words, bit j of word i for slot 32·i + j.
    The words are summed in int64 (PyTorch's CUDA uint32 arithmetic is
    thin) and narrowed to int32 on the device."""
    p = v.shape[-1]
    vpad = torch.nn.functional.pad(v.to(torch.int64), (0, (-p) % 32))
    vpad = vpad.reshape(v.shape[:-1] + (-1, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=v.device)
    return _narrow((vpad << shifts).sum(dim=-1), 32)


def _drop_scatter(idx, values, p: int, dtype):
    """``values`` scattered to ``idx`` along the last axis of a [..., P]
    buffer of zeros; index P (the trash slot) drops an entry."""
    out = torch.zeros(idx.shape[:-1] + (p + 1,), dtype=dtype, device=idx.device)
    out.scatter_(-1, idx, values.to(dtype))
    return out[..., :p]


def _compact_scatter(vflat, values, dtype):
    """Scatter-compact ``values`` [..., P] to the front where ``vflat``."""
    p = vflat.shape[-1]
    pos = torch.cumsum(vflat.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    idx = torch.where(vflat, pos, p).to(torch.int64)
    return _drop_scatter(idx, values, p, dtype)


def _inside(p: int, count, device):
    """Stream positions [..., P] below ``count`` (an int or a [...] tensor)."""
    iota = torch.arange(p, dtype=torch.int32, device=device)
    if isinstance(count, torch.Tensor):
        return iota < count.unsqueeze(-1), iota
    return iota < int(count), iota


def _deltas(x):
    prev = torch.nn.functional.pad(x[..., :-1], (1, 0))
    return x - prev


def _exceptions(big, d, iota):
    """(exc_idx int32 [..., P], exc_val int32 [..., P], n_exc int32 [...]):
    the stream index and the true delta of every ``big`` entry, compacted to
    the front."""
    p = big.shape[-1]
    epos = torch.cumsum(big.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    eidx = torch.where(big, epos, p).to(torch.int64)
    exc_idx = _drop_scatter(eidx, iota.expand(big.shape), p, torch.int32)
    exc_val = _drop_scatter(eidx, d, p, torch.int32)
    return exc_idx, exc_val, big.sum(dim=-1, dtype=torch.int32)


def _delta_encode(x_i32, count, limit: int, clip_dtype):
    """Compact-stream delta coding with an exception side-channel.

    ``x_i32`` [P] int32: compacted values (garbage past ``count``).
    Returns (d_small clip_dtype [P], exc_idx [P] (u32 values as int32),
    exc_val int32 [P], n_exc int32): d[i] = x[i] - x[i-1] (d[0] = x[0]);
    entries with |d| > limit are zeroed in d_small and appended (stream
    index, true delta) to the exception arrays, compacted to the front.
    Host decode (:func:`_delta_decode`) is exact for any input.
    """
    d = _deltas(x_i32)
    inside, iota = _inside(x_i32.shape[-1], count, x_i32.device)
    big = (d.abs() > limit) & inside
    d_small = torch.where(big | ~inside, 0, d).to(clip_dtype)
    return (d_small, *_exceptions(big, d, iota))


def _delta_encode4(x_i32, count):
    """Nibble (4-bit) variant of :func:`_delta_encode`: deltas clip to
    [-8, 7] with the rest on the exception channel, two deltas a byte
    (biased by +8; an odd stream's last byte pads its high half with 0).
    Returns (nibbles u8 [..., ceil(P/2)], exc_idx, exc_val, n_exc)."""
    d = _deltas(x_i32)
    inside, iota = _inside(x_i32.shape[-1], count, x_i32.device)
    big = ((d > 7) | (d < -8)) & inside
    enc = torch.where(big | ~inside, 0, d) + 8  # [0, 15]
    if x_i32.shape[-1] % 2:
        enc = torch.nn.functional.pad(enc, (0, 1))
    pairs = enc.reshape(enc.shape[:-1] + (-1, 2))
    nibbles = (pairs[..., 0] | (pairs[..., 1] << 4)).to(torch.uint8)
    return (nibbles, *_exceptions(big, d, iota))


# -- host decoders --------------------------------------------------------------

def _decode(q_f32, lo, hi, levels):
    """Fused single-pass f32 dequantization lo + q·(hi-lo)/(levels-1): the
    scale in f64, then one f32 multiply-add (≤ 1 f32 ulp of the exact
    value for q ≤ 2^24)."""
    scale = np.float32(float(hi - lo) / (levels - 1.0))
    return q_f32 * scale + np.float32(lo)


def _delta_decode(d_small, exc_idx, exc_val):
    """Host inverse of :func:`_delta_encode`."""
    d = np.asarray(d_small).astype(np.int64)
    if exc_idx.size:
        d[np.asarray(exc_idx).astype(np.int64)] = exc_val
    return np.cumsum(d)


def _delta_decode4(nibbles, n, exc_idx, exc_val):
    """Host inverse of :func:`_delta_encode4` for a stream of ``n``."""
    b = np.asarray(nibbles, np.uint8)
    d = np.empty(b.size * 2, np.int64)
    d[0::2] = (b & 15).astype(np.int64) - 8
    d[1::2] = (b >> 4).astype(np.int64) - 8
    d = d[:n]
    if exc_idx.size:
        d[np.asarray(exc_idx).astype(np.int64)] = exc_val
    return np.cumsum(d)


# -- the frame codec ------------------------------------------------------------

def pack_frame_stream(valid, image, exc_cap: int):
    """No-sync lossless frame pack: static shapes, so a caller can submit the
    fetch right after the launches, with no count to wait for.

    ``valid`` [..., H, W, K] bool, ``image`` [..., H, W, 3] u8 (a leading
    frame axis packs each frame alone). Nibble streams cover every pixel
    (entries past the compact count encode zero deltas and are cut at
    decode); the exception arrays are cut to ``exc_cap``, and ``counts``
    report the true exception numbers, so a decoder that sees more than
    ``exc_cap`` refuses the frame (:func:`unpack_frame_stream` returns None).

    Returns (bits [..., ceil(HW/32)] u32 words as int32, img_n u8 [..., 3,
    ceil(HW/2)], img_ei [..., 3, min(exc_cap, HW)] u32 values as int32,
    img_ev int32 [..., 3, min(exc_cap, HW)], counts int32 [..., 4] = (n_px,
    ne_r, ne_g, ne_b)).
    """
    lead = valid.shape[:-3]
    hw = valid.shape[-3] * valid.shape[-2]
    pv = valid.reshape(lead + (hw, -1)).any(dim=-1)
    n_px = pv.sum(dim=-1, dtype=torch.int32)
    img = image.reshape(lead + (hw, 3)).to(torch.int32)
    # one scatter compacts the three channels, packed 8 bits each in an int32
    packed_rgb = img[..., 0] | (img[..., 1] << 8) | (img[..., 2] << 16)
    x_rgb = _compact_scatter(pv, packed_rgb, torch.int32)
    nibbles, eis, evs, nes = [], [], [], []
    for c in range(3):
        nb, ei, ev, ne = _delta_encode4((x_rgb >> (8 * c)) & 255, n_px)
        nibbles.append(nb)
        eis.append(ei[..., :exc_cap])
        evs.append(ev[..., :exc_cap])
        nes.append(ne)
    return (_bitmask(pv), torch.stack(nibbles, dim=-2), torch.stack(eis, dim=-2),
            torch.stack(evs, dim=-2), torch.stack([n_px] + nes, dim=-1))


def pack_frame_compact(valid, image):
    """Lossless frame pack for fetches sliced to their counts: hit pixels
    ship as per-channel 4-bit stream deltas behind the validity bitmask,
    about 1.5 B a hit pixel against 3 B for every pixel, reconstructed bit
    for bit by :func:`unpack_frame_compact` for any composited frame
    (no-hit pixels are exactly the constant ``frame_base_rgb``).

    :func:`pack_frame_stream` with an uncapped exception channel; the same
    returns. Fetch ``img_n[c, :(n_px + 1) // 2]`` and each channel's
    exceptions cut to its count. ``valid`` / ``image`` may carry a leading
    frame axis (JAX's ``jax.vmap(pack_frame_compact)``).
    """
    return pack_frame_stream(valid, image, valid.shape[-3] * valid.shape[-2])


def unpack_frame_compact(bits, channels, sky_rgb, h: int, w: int, n_px: int):
    """Host inverse of :func:`pack_frame_compact` → [H, W, 3] u8.

    ``channels``: three (nibbles, exc_idx, exc_val) triples, each cut to its
    counts."""
    hw = h * w
    words = np.ascontiguousarray(_u32(bits).reshape(-1))
    pv = np.unpackbits(words.view(np.uint8), bitorder="little")[:hw].astype(bool)
    image = np.empty((hw, 3), np.uint8)
    image[:] = np.asarray(sky_rgb, np.uint8)
    image[pv] = np.stack(
        [_delta_decode4(nb, n_px, ei, ev).astype(np.uint8) for nb, ei, ev in channels],
        axis=-1,
    )
    return image.reshape(h, w, 3)


def unpack_frame_stream(bits, img_n, img_ei, img_ev, counts, sky_rgb,
                        h: int, w: int, exc_cap: int):
    """Host inverse of :func:`pack_frame_stream` → [H, W, 3] u8, or None
    when a channel overflowed ``exc_cap`` (the caller fetches the raw
    frame)."""
    counts = np.asarray(counts)
    n_px = int(counts[0])
    if int(counts[1:].max(initial=0)) > exc_cap:
        return None
    img_n = np.asarray(img_n).reshape(3, -1)
    img_ei = np.asarray(img_ei).reshape(3, -1)
    img_ev = np.asarray(img_ev).reshape(3, -1)
    return unpack_frame_compact(
        bits,
        [(img_n[c], img_ei[c, : int(counts[1 + c])], img_ev[c, : int(counts[1 + c])])
         for c in range(3)],
        sky_rgb, h, w, n_px,
    )


def frame_base_rgb(coloring, fog_distance) -> np.ndarray:
    """The composited frame's constant no-hit color as u8: the coloring's
    sky, or the fog base when fog is configured (renderer/mod.rs:395-411)."""
    from ..ops.coloring import fog_color, sky_color

    base = fog_color() if fog_distance is not None else sky_color(coloring)
    return np.trunc(np.asarray(base) * 255.0).astype(np.uint8)


# -- viewer fields: dense range coding --------------------------------------------

def pack_viewer_fields(key, dlat, dlon, elevation):
    """[H, W, K] fields → (key f32 [P], dlat [P], dlon [P] (u32 codes as
    int32), elevation [P] (u16 codes as int16), ranges f32 [6]), P = H·W·K:
    14 B a pixel slot."""
    valid = torch.isfinite(key)
    la_lo, la_hi = _masked_range(dlat, valid)
    lo_lo, lo_hi = _masked_range(dlon, valid)
    el_lo, el_hi = _masked_range(elevation, valid)
    la = _range_code(torch.where(valid, dlat, la_lo), la_lo, la_hi, _LEVELS)
    lo = _range_code(torch.where(valid, dlon, lo_lo), lo_lo, lo_hi, _LEVELS)
    el = _narrow(_range_code(torch.where(valid, elevation, el_lo), el_lo, el_hi,
                             65536.0), 16)
    ranges = torch.stack([la_lo, la_hi, lo_lo, lo_hi, el_lo, el_hi])
    return key.reshape(-1), la.reshape(-1), lo.reshape(-1), el.reshape(-1), ranges


class ViewerFields:
    """Host-side staged viewer metadata with lazy decoding (JAX
    ``ViewerFields``): full-frame arrays decode on first access, and
    :meth:`pixel` decodes one pixel's K slots, as the reference viewer
    formats only the selected pixel (viewer/app.rs:112-176).

    Iterating yields ``(valid, key, distance, dlat, dlon, elevation)`` as
    [H, W, K] arrays.
    """

    def __init__(self, key: np.ndarray, la: np.ndarray, lo: np.ndarray,
                 el: np.ndarray, ranges: np.ndarray,
                 shape: Tuple[int, ...], step: float):
        p = int(np.prod(shape))
        self._key_flat = np.asarray(key, np.float32).reshape(-1)
        self._la_flat = _u32(la).reshape(-1)
        self._lo_flat = _u32(lo).reshape(-1)
        self._el_flat = _u16(el).reshape(-1)
        for seg in (self._key_flat, self._la_flat, self._lo_flat, self._el_flat):
            if seg.size != p:
                raise ValueError(f"segment size {seg.size} != P={p}")
        self.ranges = np.asarray(ranges, np.float64)
        self.shape = tuple(shape)
        self.step = float(step)
        self._p = p
        self._cache: dict = {}

    @property
    def nbytes(self) -> int:
        """Staged payload size (14 B per pixel-slot)."""
        return (self._key_flat.nbytes + self._la_flat.nbytes
                + self._lo_flat.nbytes + self._el_flat.nbytes)

    def _get(self, name, make):
        if name not in self._cache:
            self._cache[name] = make()
        return self._cache[name]

    @property
    def key(self):
        return self._get("key", lambda: self._key_flat.reshape(self.shape))

    @property
    def valid(self):
        return self._get("valid", lambda: np.isfinite(self.key))

    @property
    def distance(self):
        # the f32 expression of the device hit path: bit-exact
        return self._get("distance", lambda: (
            np.where(self.valid, self.key, np.float32(0.0)) * np.float32(self.step)
        ).astype(np.float32))

    def _field(self, name, flat, lo, hi, levels):
        return self._get(name, lambda: _decode(
            flat.astype(np.float32), lo, hi, levels).reshape(self.shape))

    @property
    def dlat(self):
        return self._field("dlat", self._la_flat, self.ranges[0], self.ranges[1], _LEVELS)

    @property
    def dlon(self):
        return self._field("dlon", self._lo_flat, self.ranges[2], self.ranges[3], _LEVELS)

    @property
    def elevation(self):
        return self._field("elevation", self._el_flat, self.ranges[4], self.ranges[5],
                           65536.0)

    def pixel(self, y: int, x: int):
        """Decode one pixel's slots → dict of [K] arrays."""
        h, w = self.shape[0], self.shape[1]
        k = self._p // (h * w)
        base = (y * w + x) * k
        sl = slice(base, base + k)
        key = self._key_flat[sl]
        valid = np.isfinite(key)
        la_lo, la_hi, lo_lo, lo_hi, el_lo, el_hi = self.ranges
        return {
            "valid": valid,
            "key": key,
            "distance": (np.where(valid, key, np.float32(0.0))
                         * np.float32(self.step)).astype(np.float32),
            "dlat": _decode(self._la_flat[sl].astype(np.float32), la_lo, la_hi, _LEVELS),
            "dlon": _decode(self._lo_flat[sl].astype(np.float32), lo_lo, lo_hi, _LEVELS),
            "elevation": _decode(self._el_flat[sl].astype(np.float32), el_lo, el_hi,
                                 65536.0),
        }

    def __iter__(self):
        return iter((self.valid, self.key, self.distance, self.dlat, self.dlon,
                     self.elevation))


def unpack_viewer_fields(key, la, lo, el, ranges: np.ndarray,
                         shape: Tuple[int, ...], step: float):
    """Host inverse of :func:`pack_viewer_fields`: (valid, key, distance,
    dlat, dlon, elevation) as [H, W, K] arrays."""
    return tuple(ViewerFields(key, la, lo, el, ranges, shape, step))


def fetch_viewer_fields(hits, step: float) -> ViewerFields:
    """The viewer metadata of device hits through :func:`pack_viewer_fields`:
    its segments in one ``fetch_flat_many``, decoded lazily."""
    from ..generators.base import fetch_flat_many

    key, la, lo, el, ranges = pack_viewer_fields(hits.key, hits.dlat, hits.dlon,
                                                 hits.elevation)
    key_h, la_h, lo_h, el_h, ranges_h = fetch_flat_many((key, la, lo, el, ranges))
    return ViewerFields(key_h, la_h, lo_h, el_h, ranges_h, tuple(hits.key.shape), step)


# -- viewer fields: separable (Fast) staging ----------------------------------------

def _elevation_codes(valid, elevation):
    """(u16 codes as int32 [..], el_lo, el_hi) of the valid slots' elevation."""
    el_lo, el_hi = _masked_range(elevation, valid)
    code = _range_code(torch.where(valid, elevation, el_lo), el_lo, el_hi, 65536.0)
    return code, el_lo, el_hi


def pack_viewer_fields_separable(key, elevation):
    """Separable pack for Fast hits: the key (f32, exact) and the u16
    range-coded elevation of the valid slots only, compacted to the front
    behind the validity bitmask; lat/lon are derived on the host
    (:class:`ViewerFieldsSeparable`). About 6 B a valid slot.

    Returns (bits [ceil(P/32)] u32 words as int32, key_c f32 [P], el_c [P]
    u16 codes as int16, el_ranges f32 [2], count int32); fetch the first
    ``count`` of key_c and el_c. Only for hits on the column geodesic (Fast
    terrain hits, no scene objects).
    """
    valid = torch.isfinite(key)
    code, el_lo, el_hi = _elevation_codes(valid, elevation)
    vflat = valid.reshape(-1)
    key_c = _compact_scatter(vflat, key.reshape(-1), torch.float32)
    el_c = _narrow(_compact_scatter(vflat, code.reshape(-1), torch.int32), 16)
    count = vflat.sum(dtype=torch.int32)
    return _bitmask(vflat), key_c, el_c, torch.stack([el_lo, el_hi]), count


class ViewerFieldsSeparable:
    """Host container for the separable pack: lat/lon derived, not staged
    (JAX ``ViewerFieldsSeparable``).

    The surface of :class:`ViewerFields`; ``dlat`` / ``dlon`` are
    recomputed in f64 from (column azimuth, key) with the device's
    endpoint lerp, ``lerp(geodesic(az, floor(k)·step), geodesic(az,
    (floor(k)+1)·step), frac)``, through ``model.coords_at_dist_host``.
    """

    def __init__(self, bits: np.ndarray, key_c: np.ndarray, el_c: np.ndarray,
                 el_ranges: np.ndarray, shape: Tuple[int, ...], step: float,
                 model, lat0: float, lon0: float, az_deg: np.ndarray):
        p = int(np.prod(shape))
        self._bits = _u32(bits).reshape(-1)
        if self._bits.size != (p + 31) // 32:
            raise ValueError(f"bitmask words {self._bits.size} != ceil(P/32) for P={p}")
        self._key_c = np.asarray(key_c, np.float32).reshape(-1)
        self._el_c = _u16(el_c).reshape(-1)
        self.el_ranges = np.asarray(el_ranges, np.float64)
        self.shape = tuple(shape)
        self.step = float(step)
        self.model = model
        self.lat0 = float(lat0)
        self.lon0 = float(lon0)
        self.az_deg = np.asarray(az_deg, np.float64).reshape(-1)
        if self.az_deg.size != self.shape[1]:
            raise ValueError("az_deg must have one entry per column")
        self._p = p
        self._cache: dict = {}

    @property
    def nbytes(self) -> int:
        """Staged payload (bitmask + compacted key/elevation segments)."""
        return self._bits.nbytes + self._key_c.nbytes + self._el_c.nbytes

    def _get(self, name, make):
        if name not in self._cache:
            self._cache[name] = make()
        return self._cache[name]

    @property
    def valid(self):
        def make():
            w = self._bits.shape[0]
            v = ((self._bits[:, None] >> np.arange(32, dtype=np.uint32)) & 1
                 ).astype(bool).reshape(w * 32)[: self._p]
            return v.reshape(self.shape)

        return self._get("valid", make)

    @property
    def _positions(self):
        # flat slot -> compact index (valid slots only), 4 B a slot
        return self._get("_positions", lambda: np.cumsum(
            self.valid.reshape(-1), dtype=np.int32) - 1)

    @property
    def _count(self) -> int:
        return self._get("_count", lambda: int(self.valid.reshape(-1).sum()))

    @property
    def key(self):
        def make():
            out = np.full(self._p, np.inf, np.float32)
            out[self.valid.reshape(-1)] = self._key_c[: self._count]
            return out.reshape(self.shape)

        return self._get("key", make)

    @property
    def distance(self):
        # the f32 expression of the device hit path: bit-exact
        return self._get("distance", lambda: (
            np.where(self.valid, self.key, np.float32(0.0)) * np.float32(self.step)
        ).astype(np.float32))

    @property
    def elevation(self):
        el_lo, el_hi = self.el_ranges[0], self.el_ranges[1]

        def make():
            out = np.full(self._p, np.float32(el_lo), np.float32)
            out[self.valid.reshape(-1)] = _decode(
                self._el_c[: self._count].astype(np.float32), el_lo, el_hi, 65536.0)
            return out.reshape(self.shape)

        return self._get("elevation", make)

    def _derive_latlon(self, keys: np.ndarray, cols: np.ndarray):
        """f64 (dlat, dlon) for valid keys in columns ``cols`` (flat arrays):
        the device lerp between consecutive geodesic samples; dlon wraps
        into (-180, 180]."""
        k = np.floor(keys.astype(np.float64))
        frac = keys.astype(np.float64) - k
        az = self.az_deg[cols]
        la1, lo1 = self.model.coords_at_dist_host(self.lat0, self.lon0, az, k * self.step)
        la2, lo2 = self.model.coords_at_dist_host(self.lat0, self.lon0, az,
                                                  (k + 1.0) * self.step)
        dlat = (la1 - self.lat0) * (1.0 - frac) + (la2 - self.lat0) * frac

        def wrap(x):
            return (x + 180.0) % 360.0 - 180.0

        dlon = wrap(lo1 - self.lon0) * (1.0 - frac) + wrap(lo2 - self.lon0) * frac
        return dlat, dlon

    def _latlon_full(self):
        def make():
            idx = np.nonzero(self.valid.reshape(-1))[0]
            k = self.shape[2] if len(self.shape) > 2 else 1
            cols = (idx // k) % self.shape[1]
            dlat = np.zeros(self._p, np.float64)
            dlon = np.zeros(self._p, np.float64)
            if idx.size:
                dla, dlo = self._derive_latlon(self._key_c[: idx.size], cols)
                dlat[idx] = dla
                dlon[idx] = dlo
            return dlat.reshape(self.shape), dlon.reshape(self.shape)

        return self._get("_latlon", make)

    @property
    def dlat(self):
        return self._latlon_full()[0]

    @property
    def dlon(self):
        return self._latlon_full()[1]

    def _rank(self, base: int) -> int:
        """Valid slots strictly before flat slot ``base`` (bitmask popcount),
        so one pixel's decode needs no full-frame index."""
        wq, r = divmod(base, 32)
        c = int(_popcount(self._bits[:wq]).sum(dtype=np.int64))
        if r:
            c += int(_popcount(self._bits[wq] & np.uint32((1 << r) - 1)))
        return c

    def pixel(self, y: int, x: int):
        """Decode one pixel's slots → dict of [K] arrays."""
        h, w = self.shape[0], self.shape[1]
        k = self._p // (h * w)
        base = (y * w + x) * k
        if "_positions" in self._cache:
            vflat = self.valid.reshape(-1)[base: base + k]
            pos = self._positions[base: base + k]
        else:
            sl = np.arange(base, base + k)
            vflat = ((self._bits[sl >> 5] >> (sl & 31).astype(np.uint32)) & 1).astype(bool)
            # the running rank within the pixel, offset by all before it
            pos = self._rank(base) + np.cumsum(vflat, dtype=np.int32) - 1
        key = np.full(k, np.inf, np.float32)
        el = np.zeros(k, np.float32)
        el_lo, el_hi = self.el_ranges[0], self.el_ranges[1]
        if vflat.any():
            key[vflat] = self._key_c[pos[vflat]]
            el[vflat] = _decode(self._el_c[pos[vflat]].astype(np.float32), el_lo, el_hi,
                                65536.0)
        el[~vflat] = np.float32(el_lo)
        dlat = np.zeros(k, np.float64)
        dlon = np.zeros(k, np.float64)
        if vflat.any():
            dla, dlo = self._derive_latlon(key[vflat], np.full(int(vflat.sum()), x, np.int64))
            dlat[vflat] = dla
            dlon[vflat] = dlo
        return {
            "valid": vflat,
            "key": key,
            "distance": (np.where(vflat, key, np.float32(0.0))
                         * np.float32(self.step)).astype(np.float32),
            "dlat": dlat,
            "dlon": dlon,
            "elevation": el,
        }

    def __iter__(self):
        return iter((self.valid, self.key, self.distance, self.dlat, self.dlon,
                     self.elevation))


def _separable_azimuths(result, what: str) -> np.ndarray:
    az = np.asarray(result.azimuth_deg)
    if az.ndim != 1 or az.size != result.hits.key.shape[1]:
        raise ValueError(f"{what} needs a separable [W] azimuth grid (Fast generator)")
    return az


def fetch_viewer_fields_separable(result, model, step: float, co_fetch=()):
    """Fast-generator viewer metadata to the host through
    :func:`pack_viewer_fields_separable`: the bitmask and the valid slots'
    key and elevation, after one sync for their count.

    ``result``: a Fast render's RenderResult (a [W] azimuth grid, device
    hits, no scene objects). ``co_fetch``: more tensors (the image, say),
    submitted first, before the pack is launched, so their copies run on
    the copy stream under the pack and the count's sync. Returns the
    :class:`ViewerFieldsSeparable`, or ``(vf, [flat extras...])`` with
    ``co_fetch``.
    """
    from ..generators.base import fetch_pool, submit_fetch

    hits = result.hits
    az = _separable_azimuths(result, "fetch_viewer_fields_separable")
    co_fetch = tuple(co_fetch)
    with fetch_pool() as pool:
        co_outs, _ = submit_fetch(pool, co_fetch)
        bits, key_c, el_c, ranges, count = pack_viewer_fields_separable(
            hits.key, hits.elevation)
        n = int(count)  # the one sync: the count
        (bits_h, key_h, el_h, ranges_h), _ = submit_fetch(
            pool, (bits, key_c[:n], el_c[:n], ranges))
    lat0, lon0 = float(result.observer[0]), float(result.observer[1])
    vf = ViewerFieldsSeparable(bits_h, key_h, el_h, ranges_h, tuple(hits.key.shape),
                               step, model, lat0, lon0, az)
    return (vf, list(co_outs)) if co_fetch else vf


# -- viewer fields: the delta pack (v3) -----------------------------------------------

_KEY_QUANT = 256.0  # 1/256 march-step key fixed point of the delta pack:
# distance quantum step/256 (0.195 m at 50 m steps), derived lat/lon within
# ~0.2 m — under the viewer's display steps (0.001 km, 0.01" ≈ 0.31 m)


def pack_viewer_fields_delta(key, elevation, image):
    """Delta pack v3: the separable pack's payload delta-coded, plus the
    frame compacted to hit pixels.

    Per valid slot: the key as an i8 stream delta of its 1/256-step fixed
    point (``_KEY_QUANT``) and the elevation as a 4-bit stream delta of the
    separable pack's u16 code (it decodes bit-equal). Per hit pixel: each
    u8 channel as a 4-bit stream delta; no-hit pixels are the constant
    ``frame_base_rgb``. Every overflow rides the exception channel, so the
    coding is lossless for any input (8 B an overflow). Fast frames without
    scene objects only; a K-slot pixel is a hit pixel if any slot is valid.

    Returns (bits, key_d i8, key_exc_idx, key_exc_val, el_n u8 nibbles,
    el_exc_idx, el_exc_val, el_ranges f32 [2], img_n u8 [3, ceil(Ppx/2)],
    img_exc_idx [3, Ppx], img_exc_val [3, Ppx], counts int32 [7] =
    (n_valid, n_px, n_key_exc, n_el_exc, n_r_exc, n_g_exc, n_b_exc)); the
    u32 words and indices as int32.
    """
    valid = torch.isfinite(key)
    code, el_lo, el_hi = _elevation_codes(valid, elevation)
    vflat = valid.reshape(-1)
    count = vflat.sum(dtype=torch.int32)
    q = torch.where(valid, torch.round(key * _KEY_QUANT), 0.0).to(torch.int32)
    q_c = _compact_scatter(vflat, q.reshape(-1), torch.int32)
    el_c = _compact_scatter(vflat, code.reshape(-1), torch.int32)
    key_d, kexc_i, kexc_v, n_kexc = _delta_encode(q_c, count, 127, torch.int8)
    el_n, eexc_i, eexc_v, n_eexc = _delta_encode4(el_c, count)

    pv = valid.reshape(valid.shape[0] * valid.shape[1], -1).any(dim=-1)
    n_px = pv.sum(dtype=torch.int32)
    img = image.reshape(-1, 3).to(torch.int32)
    img_ns, img_eis, img_evs, img_counts = [], [], [], []
    for c in range(3):
        nb, ei, ev, ne = _delta_encode4(_compact_scatter(pv, img[:, c], torch.int32), n_px)
        img_ns.append(nb)
        img_eis.append(ei)
        img_evs.append(ev)
        img_counts.append(ne)
    counts = torch.stack([count, n_px, n_kexc, n_eexc] + img_counts)
    return (_bitmask(vflat), key_d, kexc_i, kexc_v, el_n, eexc_i, eexc_v,
            torch.stack([el_lo, el_hi]), torch.stack(img_ns), torch.stack(img_eis),
            torch.stack(img_evs), counts)


def fetch_viewer_fields_delta(result, model, step: float, sky_rgb, co_fetch=()):
    """Viewer metadata and frame to the host through the delta pack.

    The contract of :func:`fetch_viewer_fields_separable`, and the no-hit
    region of the frame must be the one color ``sky_rgb`` (u8 triple).
    ``result.image`` may be on the host or the device. Returns ``(vf, image,
    stats)``: a :class:`ViewerFieldsSeparable` whose keys carry the
    1/256-step fixed point, the reconstructed [H, W, 3] u8 frame, and the
    staged byte count with the counts; ``(vf, image, stats, extras)`` with
    ``co_fetch``.
    """
    from ..generators.base import fetch_pool, submit_fetch

    hits = result.hits
    az = _separable_azimuths(result, "fetch_viewer_fields_delta")
    h, w = hits.key.shape[0], hits.key.shape[1]
    device = hits.key.device
    image = result.image
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    co_fetch = tuple(co_fetch)
    with fetch_pool() as pool:
        co_outs, _ = submit_fetch(pool, co_fetch)
        (bits, key_d, kexc_i, kexc_v, el_n, eexc_i, eexc_v, el_ranges,
         img_n, img_ei, img_ev, counts) = pack_viewer_fields_delta(
            hits.key, hits.elevation, image)
        n, n_px, n_kexc, n_eexc, n_r, n_g, n_b = counts.tolist()  # the one sync
        segs = [bits, key_d[:n], kexc_i[:n_kexc], kexc_v[:n_kexc],
                el_n[:(n + 1) // 2], eexc_i[:n_eexc], eexc_v[:n_eexc]]
        for c, ne in enumerate((n_r, n_g, n_b)):
            segs += [img_n[c, :(n_px + 1) // 2], img_ei[c, :ne], img_ev[c, :ne]]
        meta_outs, _ = submit_fetch(pool, segs + [el_ranges])
    *meta_outs, el_ranges_h = meta_outs
    (bits_h, key_d_h, kexc_i_h, kexc_v_h, el_n_h, eexc_i_h, eexc_v_h,
     rn_h, rei_h, rev_h, gn_h, gei_h, gev_h, bn_h, bei_h, bev_h) = meta_outs
    staged = sum(int(s.nbytes) for s in meta_outs)

    q = _delta_decode(key_d_h, kexc_i_h, kexc_v_h)
    key_c = (q.astype(np.float64) / _KEY_QUANT).astype(np.float32)
    el_h = _delta_decode4(el_n_h, n, eexc_i_h, eexc_v_h).astype(np.uint16)
    lat0, lon0 = float(result.observer[0]), float(result.observer[1])
    vf = ViewerFieldsSeparable(bits_h, key_c, el_h, el_ranges_h, tuple(hits.key.shape),
                               step, model, lat0, lon0, az)

    frame = np.empty((h * w, 3), np.uint8)
    frame[:] = np.asarray(sky_rgb, np.uint8)
    pv = vf.valid.reshape(h * w, -1).any(-1)
    for c, (nb, ei, ev) in enumerate(((rn_h, rei_h, rev_h), (gn_h, gei_h, gev_h),
                                      (bn_h, bei_h, bev_h))):
        frame[pv, c] = _delta_decode4(nb, n_px, ei, ev).astype(np.uint8)
    stats = {
        "staged_bytes": staged,
        "n_valid": int(n),
        "n_hit_px": int(n_px),
        "n_exceptions": int(n_kexc + n_eexc + n_r + n_g + n_b),
    }
    frame = frame.reshape(h, w, 3)
    return (vf, frame, stats) if not co_fetch else (vf, frame, stats, list(co_outs))
