# Frozen copy of atm_raytracer_tpu_torch/ops/combine.py (commit 05461a6); the benchmark's reference, not the program.
"""Crossing-detection combine: ray altitudes × terrain elevations → hit segments.

Counterpart of ``atm_raytracer_tpu/ops/combine.py``. The reference marches
each pixel's ray with early exit (utils.rs:201-289): segment k crosses the
terrain iff d1·d2 < 0 with d = ray_elev − terrain_elev at its two ends, and
the hit lerps by prop = d1/(d1−d2) (utils.rs:220-240). The Fast generator's
separability turns this into a rank-1 program: ray rows [H, N+1] × terrain
columns [W, N_t] → the first K crossing SEGMENT INDICES per pixel [H, W, K].

``terrain_crossing_segments_plain`` is the H·W·N hot loop, in chunks of
segments.

A sweep's frames ride a leading axis: ray rows [F, H, N+1] against
terrain columns [F, W, N_t] give [F, H, W, K], frame f's rays meeting only
frame f's columns.

Path death (gen_path_cache stops one element after h < −1000,
utils.rs:159-171): segment k of ray h participates iff no sample j < k of
that ray is below −1000 m.
"""

from __future__ import annotations

import torch

from ..physics.ray import DEATH_ALTITUDE

NO_HIT = float("inf")
NO_HIT_SEG = 2**30  # integer sentinel (segment index form)


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


