"""The one generator of traffic: the sequence of views a user asks for.

A traffic file (``traffic/<name>.json``) names the generator, the tilt and
the range of directions. Directions are uniform over the range by strata:
the range cut into ``strata`` equal parts, one direction in each, visited
in an order drawn from the seed, a new order each pass. Pass p puts its
directions at the fraction 0.5 + p * ``PASS_SHIFT`` (mod 1) of their
strata, the golden ratio's 0.618...: no view ever comes back, as none does
for a user who pans, so no cache the program keys on the view can hit.
Every seed asks for the same views, and so the same work, in another
order; a window holds a few passes or more.
"""

from __future__ import annotations

import numpy as np

PASS_SHIFT = (5.0 ** 0.5 - 1.0) / 2.0  # the golden ratio's fraction, 0.618...


def directions(traffic: dict, seed: int, stream: int = 0):
    """Endless directions (degrees) of ``traffic`` for ``seed``; ``stream``
    picks an independent sequence (0 the measured one, 1 the warm-up)."""
    lo, hi = (float(v) for v in traffic["direction_deg"])
    strata = int(traffic["strata"])
    rng = np.random.default_rng([int(seed), 2, int(stream)])
    p = 1000 * int(stream)  # the warm-up's passes are none of the window's
    while True:
        frac = (0.5 + p * PASS_SHIFT) % 1.0
        for k in rng.permutation(strata):
            yield lo + (hi - lo) * (float(k) + frac) / strata
        p += 1


def frame_stats(starts, ends):
    """(frame_ms, frame_p95_ms) of frames that began at ``starts`` and
    ended at ``ends`` (seconds): the window from the first start to the
    last end over the frames, and the 95th percentile of the frames' walls
    (linear between order statistics)."""
    n = len(starts)
    if n == 0:
        return None, None
    frame_ms = (ends[-1] - starts[0]) * 1e3 / n
    walls = (np.asarray(ends) - np.asarray(starts)) * 1e3
    return float(frame_ms), float(np.percentile(walls, 95.0))
