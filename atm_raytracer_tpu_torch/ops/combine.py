"""Crossing-detection combine: ray altitudes × terrain elevations → hit segments.

Counterpart of ``atm_raytracer_tpu/ops/combine.py``. The reference marches
each pixel's ray with early exit (utils.rs:201-289): segment k crosses the
terrain iff d1·d2 < 0 with d = ray_elev − terrain_elev at its two ends, and
the hit lerps by prop = d1/(d1−d2) (utils.rs:220-240). The Fast generator's
separability turns this into a rank-1 program: ray rows [H, N+1] × terrain
columns [W, N_t] → the first K crossing SEGMENT INDICES per pixel [H, W, K].

``terrain_crossing_segments`` is the H·W·N hot loop: on CUDA tensors it
launches the kernel ``csrc/combine.cu`` (K1); on CPU tensors it runs the
plain chunked PyTorch version ``terrain_crossing_segments_plain``. K1 first
takes the min and max of each block tile's rows over each chunk of
segments (``crossing_envelopes_plain`` is its plain version) and skips the
chunks whose ray and terrain envelopes do not overlap: no segment there
can cross.

A sweep's frames ride a leading axis: ray rows [F, H, N+1] against
terrain columns [F, W, N_t] give [F, H, W, K], frame f's rays meeting only
frame f's columns, in one K1 launch.

Path death (gen_path_cache stops one element after h < −1000,
utils.rs:159-171): segment k of ray h participates iff no sample j < k of
that ray is below −1000 m.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..physics.ray import DEATH_ALTITUDE

NO_HIT = float("inf")
NO_HIT_SEG = 2**30  # integer sentinel (segment index form)
# K1's block tile and segment chunk (csrc/combine.cu TH, TW, CH)
TILE_H = 8
TILE_W = 32
CHUNK = 128


def ray_alive_mask(ray_h: torch.Tensor) -> torch.Tensor:
    """alive[h, k] = segment k of ray h is marched (no earlier death).

    ray_h: [H, N+1]; returns [H, N] bool for segments k = 0..N-1.
    """
    dead = ray_h[:, :-1] < DEATH_ALTITUDE
    prefix = torch.cumsum(dead.to(torch.int32), dim=1)
    no_prior = torch.cat(
        [torch.zeros_like(prefix[:, :1]), prefix[:, :-1]], dim=1
    )
    return no_prior == 0


def ray_death_limit(ray_h: torch.Tensor, n_seg: int) -> torch.Tensor:
    """[..., H] int32 bound: segments k < limit[h] are alive — the first
    sample below DEATH_ALTITUDE plus one, or n_seg for a ray that never dies."""
    dead = ray_h < DEATH_ALTITUDE
    first = torch.argmax(dead.to(torch.uint8), dim=-1)  # first max = first dead
    limit = torch.where(dead.any(dim=-1), first + 1, torch.full_like(first, n_seg))
    return limit.clamp(max=n_seg).to(torch.int32)


def k_smallest(cand: torch.Tensor, k: int) -> torch.Tensor:
    """K smallest of cand[..., C], ascending, by K successive masked mins
    (duplicate sentinels collapse to the sentinel, which is right here)."""
    sentinel = NO_HIT if cand.is_floating_point() else NO_HIT_SEG
    outs = []
    cur = cand
    for i in range(k):
        m = cur.amin(dim=-1)
        outs.append(m)
        if i + 1 < k:
            cur = torch.where(cur <= m[..., None], torch.full_like(cur, sentinel), cur)
    return torch.stack(outs, dim=-1)


def merge_sorted_k(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """K smallest of two ASCENDING [..., K] lists via a bitonic merge."""
    kp = 1 << (k - 1).bit_length()  # pad K to a power of two
    sentinel = NO_HIT if a.is_floating_point() else NO_HIT_SEG
    if kp != k:
        pad = a.new_full(a.shape[:-1] + (kp - k,), sentinel)
        a = torch.cat([a, pad], dim=-1)
        b = torch.cat([b, pad], dim=-1)
    seq = torch.cat([a, torch.flip(b, dims=[-1])], dim=-1)  # bitonic
    n = 2 * kp
    span = kp
    lead = seq.shape[:-1]
    while span >= 1:
        x = seq.reshape(lead + (n // (2 * span), 2, span))
        lo = torch.minimum(x[..., 0, :], x[..., 1, :])
        hi = torch.maximum(x[..., 0, :], x[..., 1, :])
        seq = torch.stack([lo, hi], dim=-2).reshape(lead + (n,))
        span //= 2
    return seq[..., :k]


def _check_combine_args(ray_h, terr_elev, n_seg, max_hits):
    if ray_h.ndim != terr_elev.ndim or ray_h.ndim not in (2, 3) or (
            ray_h.ndim == 3 and ray_h.shape[0] != terr_elev.shape[0]):
        raise ValueError("ray_h must be [H, N+1] and terr_elev [W, N_t], or both "
                         "with one leading frame axis [F, ...]")
    if min(ray_h.shape[-1], terr_elev.shape[-1]) < n_seg + 1:
        raise ValueError(
            f"n_seg={n_seg} needs {n_seg + 1} samples per row; got ray "
            f"{ray_h.shape[-1]}, terrain {terr_elev.shape[-1]}"
        )
    if not 1 <= max_hits <= 4:
        raise ValueError(f"max_hits must be 1..4, got {max_hits}")
    if ray_h.device != terr_elev.device:
        raise ValueError("ray_h and terr_elev live on different devices")


def terrain_crossing_segments_plain(ray_h: torch.Tensor, terr_elev: torch.Tensor,
                                    n_seg: int, max_hits: int = 1,
                                    chunk: int = 0) -> torch.Tensor:
    """Plain PyTorch combine: the [H, W, C] sign-test cube one segment chunk
    at a time, folded by an integer min (K = 1) or a sorted top-K merge.
    ``chunk`` = 0 sizes chunks to ~2^25 cube elements. A leading frame axis
    runs frame by frame."""
    _check_combine_args(ray_h, terr_elev, n_seg, max_hits)
    if ray_h.ndim == 3:
        return torch.stack([terrain_crossing_segments_plain(r, t, n_seg, max_hits, chunk)
                            for r, t in zip(ray_h, terr_elev)])
    h_n, w_n = ray_h.shape[0], terr_elev.shape[0]
    if chunk <= 0:
        chunk = int(max(1, min(256, 2**25 // max(1, h_n * w_n))))
    alive = ray_alive_mask(ray_h[:, : n_seg + 1])  # [H, n_seg]
    keys = torch.full((h_n, w_n, max_hits), NO_HIT_SEG, dtype=torch.int32,
                      device=ray_h.device)
    for k0 in range(0, n_seg, chunk):
        k1 = min(k0 + chunk, n_seg)
        d1 = ray_h[:, None, k0:k1] - terr_elev[None, :, k0:k1]  # [H, W, C]
        d2 = ray_h[:, None, k0 + 1:k1 + 1] - terr_elev[None, :, k0 + 1:k1 + 1]
        crossing = (d1 * d2 < 0.0) & alive[:, None, k0:k1]
        seg_idx = torch.arange(k0, k1, dtype=torch.int32, device=ray_h.device)
        cand = torch.where(crossing, seg_idx, NO_HIT_SEG)
        if max_hits == 1:
            keys = torch.minimum(keys, cand.amin(dim=-1, keepdim=True))
        else:
            kk = min(max_hits, k1 - k0)
            best = k_smallest(cand, kk)
            if kk < max_hits:
                best = torch.cat(
                    [best, best.new_full(best.shape[:-1] + (max_hits - kk,),
                                         NO_HIT_SEG)], dim=-1)
            keys = merge_sorted_k(keys, best, max_hits)
    return keys


def terrain_crossing_segments(ray_h: torch.Tensor, terr_elev: torch.Tensor,
                              n_seg: int, max_hits: int = 1) -> torch.Tensor:
    """First ``max_hits`` terrain-crossing SEGMENT INDICES per pixel.

    Args:
      ray_h: [H, N+1] ray altitudes at x = k*step, or [F, H, N+1].
      terr_elev: [W, N_t] terrain elevations on the same x grid (N_t ≥ n_seg+1),
        or [F, W, N_t].
      n_seg: number of segments to test.
      max_hits: K slots, 1..4 (1 for opaque terrain).

    Returns int32 [(F,) H, W, K] ascending; NO_HIT_SEG = no crossing. CPU
    tensors run the plain version; CUDA tensors launch K1 (once, whatever F
    is) or raise.
    """
    if ray_h.device.type == "cpu":
        return terrain_crossing_segments_plain(ray_h, terr_elev, n_seg, max_hits)
    if ray_h.device.type != "cuda":
        raise ValueError(f"terrain_crossing_segments: unsupported device {ray_h.device}")
    return crossing_segments_cuda(ray_h, terr_elev, n_seg, max_hits)


def _tile_envelope(rows: torch.Tensor, n_seg: int, tile: int):
    """(lo, hi) [ceil(R/tile), ceil(n_seg/CHUNK)]: min and max of each tile
    of ``tile`` rows over samples c·CHUNK … min((c+1)·CHUNK, n_seg), both
    ends included (the CHUNK+1 samples chunk c's tests read). NaN samples
    are left out (+inf / −inf where a tile-chunk holds nothing else)."""
    n_rows = rows.shape[0]
    n_tiles, n_chunks = -(-n_rows // tile), -(-n_seg // CHUNK)
    pad = rows.new_full((n_tiles * tile, n_chunks * CHUNK + 1), float("nan"),
                        dtype=torch.float32)
    pad[:n_rows, : n_seg + 1] = rows[:, : n_seg + 1]
    win = pad.unfold(1, CHUNK + 1, CHUNK).reshape(n_tiles, tile, n_chunks, CHUNK + 1)
    nan = torch.isnan(win)
    lo = torch.where(nan, float("inf"), win).amin(dim=(1, 3))
    hi = torch.where(nan, float("-inf"), win).amax(dim=(1, 3))
    return lo, hi


def crossing_envelopes_plain(ray_h: torch.Tensor, terr_elev: torch.Tensor, n_seg: int):
    """Plain version of K1's envelope prepass: (ray_lo, ray_hi) over tiles
    of TILE_H rays and (terr_lo, terr_hi) over tiles of TILE_W columns, each
    [tiles, ceil(n_seg/CHUNK)] float32. K1 skips chunk c of a block when
    ray_lo > terr_hi or ray_hi < terr_lo there. A leading frame axis gives
    each frame its own tiles: [F, tiles, chunks]."""
    if ray_h.ndim == 3:
        per_frame = [crossing_envelopes_plain(r, t, n_seg) for r, t in zip(ray_h, terr_elev)]
        return tuple(torch.stack(e) for e in zip(*per_frame))
    return (*_tile_envelope(ray_h, n_seg, TILE_H), *_tile_envelope(terr_elev, n_seg, TILE_W))


def crossing_segments_cuda(ray_h: torch.Tensor, terr_elev: torch.Tensor,
                           n_seg: int, max_hits: int) -> torch.Tensor:
    """Launch K1 (csrc/combine.cu) on CUDA tensors; int32 [(F,) H, W, K]."""
    return crossing_segments_envelopes_cuda(ray_h, terr_elev, n_seg, max_hits)[0]


def crossing_segments_envelopes_cuda(ray_h: torch.Tensor, terr_elev: torch.Tensor,
                                     n_seg: int, max_hits: int):
    """K1's segments and the envelopes its prepass wrote (the scratch, in
    ``crossing_envelopes_plain``'s order and shapes). One launch for all the
    frames of a leading frame axis; the one-frame call is F = 1."""
    _check_combine_args(ray_h, terr_elev, n_seg, max_hits)
    frames = ray_h.ndim == 3
    ray = ray_h.to(torch.float32).contiguous()
    terr = terr_elev.to(torch.float32).contiguous()
    if not frames:
        ray, terr = ray[None], terr[None]
    f_n, h_n, w_n = ray.shape[0], ray.shape[1], terr.shape[1]
    dev = ray.device
    out = torch.empty((f_n, h_n, w_n, max_hits), dtype=torch.int32, device=dev)
    n_chunks = -(-n_seg // CHUNK)
    env = tuple(torch.empty((f_n, -(-n // tile), n_chunks), dtype=torch.float32, device=dev)
                for n, tile in ((h_n, TILE_H), (h_n, TILE_H), (w_n, TILE_W), (w_n, TILE_W)))
    if f_n and h_n and w_n:
        limit = ray_death_limit(ray, n_seg).contiguous()  # [F, H]
        _kernels.COMBINE.call(
            dev, ray.data_ptr(), ray.shape[2], terr.data_ptr(), terr.shape[2],
            limit.data_ptr(), f_n, h_n, w_n, int(n_seg), int(max_hits),
            *(e.data_ptr() for e in env), out.data_ptr(),
        )
    if not frames:
        return out[0], tuple(e[0] for e in env)
    return out, env


def crossing_prop(ray_h, terr_elev, ks):
    """prop = d1/(d1−d2) at the given segments (utils.rs:232), per pixel."""
    r1, r2 = gather_ray_pairs(ray_h, ks)
    t1, t2 = gather_column_pairs(terr_elev[:, : ray_h.shape[1]], ks)
    d1 = r1 - t1
    d2 = r2 - t2
    denom = d1 - d2
    return d1 / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def gather_pairs(field: torch.Tensor, ki: torch.Tensor, axes):
    """Both segment-end values of ``field`` rows at integer segments ``ki``.

    field: [R_0, …, R_m, N(, D)]; ki: [...] int whose axes ``axes`` (m+1 of
    them, in order) pick the field's leading indices: (0,) for ray rows
    [H, N+1] at [H, W, K], (1,) for terrain columns [W, N_t] at [H, W, K],
    (0, 1) and (0, 2) for a sweep's [F, H, N+1] and [F, W, N_t] at
    [F, H, W, K]. Segments clamp to [0, N-2]. Returns (lo, hi) shaped ki(+D).
    """
    n = field.shape[len(axes)]
    index = []
    for axis in axes:
        shape = [1] * ki.ndim
        shape[axis] = ki.shape[axis]
        index.append(torch.arange(ki.shape[axis], device=ki.device).reshape(shape))
    k = ki.to(torch.int64).clamp(0, n - 2)
    return field[(*index, k)], field[(*index, k + 1)]


def gather_ray_pairs(field: torch.Tensor, ki: torch.Tensor):
    """(lo, hi) of a per-ray field [H, N+1(,D)] at segments ki [H, W, K]."""
    return gather_pairs(field, ki, (0,))


def gather_column_pairs(field: torch.Tensor, ki: torch.Tensor):
    """(lo, hi) of a per-column field [W, N_t(,D)] at segments ki [H, W, K]."""
    return gather_pairs(field, ki, (1,))


def gather_ray_field(field: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Lerp a per-ray field [B, N+1] at float keys [B, ...] (k + prop)."""
    k = torch.floor(keys)
    prop = keys - k
    lo, hi = gather_ray_pairs(field, k.to(torch.int64))
    return lo * (1.0 - prop) + hi * prop


def gather_column_field(field: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Lerp a per-column field [W, N_t(, D)] at float keys [..., W] (k + prop)."""
    k = torch.floor(keys)
    prop = keys - k
    lo, hi = gather_column_pairs(field, k.to(torch.int64))
    if field.ndim == 3:
        prop = prop[..., None]
    return lo * (1.0 - prop) + hi * prop


ALIGNED_CHUNK = 512  # segments a step of aligned_crossing_segments


def aligned_crossing_segments(ray_h: torch.Tensor, terr_elev: torch.Tensor,
                              n_seg: int, max_hits: int = 1) -> torch.Tensor:
    """Crossing segments when ray rows are ALIGNED with terrain columns.

    The Rectilinear generator at tilt 0 has a ray per pixel but an azimuth
    per column (rectilinear.rs:78-100 at pitch 0), so pixel (r, w) tests
    its own ray against column w's terrain: elementwise in w, not the
    [H, W] outer product of ``terrain_crossing_segments``.

    ray_h: [R, W, N+1] altitudes; terr_elev: [W, N_t]. Returns int32
    [R, W, max_hits] ascending, NO_HIT_SEG = no crossing. Runs
    ALIGNED_CHUNK segments at a time; past the march the rays pad with
    −1e9 m and the alive mask with False, the terrain with 0.
    """
    chunk = ALIGNED_CHUNK
    r_n, w_n, n_samp = ray_h.shape
    dev = ray_h.device
    alive = ray_alive_mask(ray_h.reshape(r_n * w_n, n_samp)).reshape(r_n, w_n, n_samp - 1)
    n_chunks = -(-n_seg // chunk)
    pad = n_chunks * chunk + 1 - n_samp
    if pad > 0:
        ray_h = torch.nn.functional.pad(ray_h, (0, pad), value=-1e9)
        alive = torch.nn.functional.pad(alive, (0, pad), value=False)
    tpad = n_chunks * chunk + 1 - terr_elev.shape[1]
    if tpad > 0:
        terr_elev = torch.nn.functional.pad(terr_elev, (0, tpad), value=0.0)
    keys = torch.full((r_n, w_n, max_hits), NO_HIT_SEG, dtype=torch.int32, device=dev)
    for k0 in range(0, n_chunks * chunk, chunk):
        seg_idx = torch.arange(k0, k0 + chunk, dtype=torch.int32, device=dev)
        d1 = ray_h[..., k0:k0 + chunk] - terr_elev[None, :, k0:k0 + chunk]
        d2 = ray_h[..., k0 + 1:k0 + chunk + 1] - terr_elev[None, :, k0 + 1:k0 + chunk + 1]
        crossing = (d1 * d2 < 0.0) & alive[..., k0:k0 + chunk] & (seg_idx < n_seg)
        cand = torch.where(crossing, seg_idx, NO_HIT_SEG)
        if max_hits == 1:
            keys = torch.minimum(keys, cand.amin(dim=-1, keepdim=True))
        else:
            keys = merge_sorted_k(keys, k_smallest(cand, max_hits), max_hits)
    return keys


def terrain_crossing_keys(ray_h, terr_elev, n_seg: int, max_hits: int = 1):
    """Float crossing keys k + prop ([H, W, K], inf = no hit)."""
    segs = terrain_crossing_segments(ray_h, terr_elev, n_seg, max_hits)
    valid = segs < n_seg
    ks = torch.where(valid, segs, 0)
    prop = crossing_prop(ray_h, terr_elev, ks)
    return torch.where(valid, ks.to(torch.float32) + prop,
                       torch.full_like(prop, np.inf))
