"""The control: the reference with its fields held in bfloat16.

The configuration computes in float32. The step below it that a later
change could take is bfloat16 storage of the fields the march and the
terrain tests read: the refraction table l(h) (values and fit), the
sampled terrain (elevation and normals) and the marched rays (altitude and
path length), on every route: the Fast and Interpolating grids, the
Rectilinear scans, row chunks and dense path. Under ``lower_precision()``
the frozen reference rounds each of them to bfloat16 where it is made, and
computes on in float32. A sound comparison has to call that output wrong.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .frozen.generators import fast, rectilinear, rectilinear_routes
from .frozen.physics import ray
from .frozen.terrain import sample


def _bf16(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if isinstance(x, tuple):
        return tuple(_bf16(v) for v in x)
    return x


def _bf16_host(values) -> np.ndarray:
    return torch.from_numpy(np.asarray(values, np.float32).copy()).to(
        torch.bfloat16).to(torch.float32).numpy()


def _rounded(fn):
    def wrapped(*args, **kwargs):
        return _bf16(fn(*args, **kwargs))
    return wrapped


def _scan_rounded(march_scan):
    """``march_scan`` whose consumer sees each window's marched altitudes
    and path lengths in bfloat16."""
    def wrapped(alt, elev_rad, step, n_steps, shape, table, straight, consumer, init,
                **kwargs):
        def rounded(carry, k0, h_f, plen_f, *rest):
            return consumer(carry, k0, _bf16(h_f), _bf16(plen_f), *rest)
        return march_scan(alt, elev_rad, step, n_steps, shape, table, straight, rounded,
                          init, **kwargs)
    return wrapped


@contextlib.contextmanager
def lower_precision():
    """Patch the frozen reference so that the table, the terrain samples and
    the march outputs (the K > 1 tilt-0 scan's windows too) are rounded to
    bfloat16; restored on exit."""
    from_values = ray.RefractionTable.from_values

    def from_values_bf16(values, h0, inv_dh, poly, device):
        if poly is not None:
            poly = tuple((lo, hi, tuple(float(c) for c in _bf16_host(cs)))
                         for lo, hi, cs in poly)
        return from_values(_bf16_host(values), h0, inv_dh, poly, device)

    patches = [(ray.RefractionTable, "from_values", staticmethod(from_values_bf16))]
    for mod in (sample, fast, rectilinear, rectilinear_routes):
        for name in ("sample_terrain_data", "sample_elevation"):
            if hasattr(mod, name):
                patches.append((mod, name, _rounded(getattr(mod, name))))
    for mod in (fast, rectilinear_routes):
        patches.append((mod, "march_rays", _rounded(mod.march_rays)))
    patches.append((rectilinear_routes, "march_scan",
                    _scan_rounded(rectilinear_routes.march_scan)))
    saved = [(obj, name, obj.__dict__[name]) for obj, name, _ in patches]
    try:
        for obj, name, new in patches:
            setattr(obj, name, new)
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)
