"""Batched sweeps and the multi-device render modes (``mesh``)."""

from .mesh import (  # noqa: F401
    dryrun_multichip,
    make_mesh,
    render_fast_sharded,
    render_interpolating_sharded,
    render_rectilinear_pixelwise_sharded,
    render_rectilinear_sharded,
    render_sweep_sharded,
)
