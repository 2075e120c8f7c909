"""The frame set-up every render entry point of the port shares
(``generators.base.frame_setup``), on the CPU.

Each one-device entry and its sharded twin over ``["cpu"]`` render with the
hit depth and the march length that the rules each entry used to write out
gave (written out again below as the oracle); every entry on one device
shares one l(h) table and one terrain pack; and the set-up alone builds
nothing on a device. The scene is ``parallel.mesh._tiny_setup``'s.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from atm_raytracer_tpu_torch.generators import base, fast  # noqa: E402
from atm_raytracer_tpu_torch.generators import interpolating as interp  # noqa: E402
from atm_raytracer_tpu_torch.generators import rectilinear as rect  # noqa: E402
from atm_raytracer_tpu_torch.parallel import mesh as M  # noqa: E402

CPU = M.make_mesh(["cpu"])


def _scene(alpha: float = 1.0):
    params, terrain = M._tiny_setup()
    return dataclasses.replace(params, terrain_alpha=alpha), terrain


def _old_depth(generator: str, alpha: float) -> int:
    """The hit depth each entry chose for itself before the shared set-up."""
    if generator == "InterpolatingRectilinear":
        return 2 if alpha >= 1.0 else 4
    return 1 if alpha >= 1.0 else 4


def _old_grid_depth(alpha: float, depth: int) -> int:
    """The snapped grid's depth of an object-free Interpolating frame."""
    return 1 if alpha >= 1.0 else depth


# generator: (the cores whose keywords are recorded, the entries, each a
# (name, render(params, terrain) -> hits) pair)
ENTRIES = {
    "Fast": ((fast, "separable_hits"), (
        ("render_fast", lambda p, t: fast.render_fast(p, t, "cpu").hits),
        ("render_fast_streamed", lambda p, t: fast.render_fast_streamed(p, t, "cpu").hits),
        ("render_fast_sharded", lambda p, t: M.render_fast_sharded(p, t, CPU).hits),
        ("render_sweep_sharded", lambda p, t: M.render_sweep_sharded(
            p, t, CPU, [45.0, 90.0], return_hits=True)[1]),
    )),
    "Rectilinear": ((rect, "fused_shared_core"), (
        ("render_rectilinear", lambda p, t: rect.render_rectilinear(p, t, "cpu").hits),
        ("render_rectilinear_sharded",
         lambda p, t: M.render_rectilinear_sharded(p, t, CPU).hits),
    )),
    "InterpolatingRectilinear": ((interp, "separable_hits"), (
        ("render_interpolating", lambda p, t: interp.render_interpolating(p, t, "cpu").hits),
        ("render_interpolating_sharded",
         lambda p, t: M.render_interpolating_sharded(p, t, CPU).hits),
    )),
}


def _record(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def recorded(*args, **kw):
        seen.append((kw["n_terr"], kw["max_hits"]))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, recorded)


@pytest.mark.parametrize("alpha", [1.0, 0.65], ids=["opaque", "translucent"])
@pytest.mark.parametrize("generator", list(ENTRIES))
def test_default_depth_and_march_length(generator, alpha, monkeypatch):
    """The one-device entry and its sharded twin call their core with
    ``ceil(max_distance / step)`` samples and the old rule's depth, and
    their hits come back that deep (Interpolating: twice its depth, from a
    grid one slot deep where the terrain is opaque)."""
    params, terrain = _scene(alpha)
    n_terr = math.ceil(params.view.frame.max_distance / params.simulation_step)
    depth = _old_depth(generator, alpha)
    core_depth, k_out = depth, depth
    if generator == "InterpolatingRectilinear":
        core_depth, k_out = _old_grid_depth(alpha, depth), 2 * depth
    (module, core), entries = ENTRIES[generator]
    seen = []
    _record(monkeypatch, module, core, seen)
    if module is interp:  # the sharded Interpolating grid goes through fast's
        _record(monkeypatch, fast, core, seen)
    for name, render in entries:
        seen.clear()
        hits = render(params, terrain)
        assert seen and set(seen) == {(n_terr, core_depth)}, (name, seen)
        assert hits.valid.shape[-1] == k_out, (name, hits.valid.shape)


def test_entries_share_one_pack_and_table(monkeypatch):
    """Every entry point on one device, the sharded ones over ``["cpu"]``,
    leaves one l(h) table in the memo and one terrain pack for the box."""
    monkeypatch.setattr(base, "_table_cache", {})
    params, terrain = _scene()
    for _, entries in ENTRIES.values():
        for _, render in entries:
            render(params, terrain)
    M.render_rectilinear_pixelwise_sharded(params, terrain, CPU)
    assert list(base._table_cache) and len(base._table_cache) == 1
    assert len(terrain._pack_cache) == 1
    setup = base.frame_setup(params, terrain)
    assert next(iter(terrain._pack_cache.values())) is setup.pack("cpu")
    assert next(iter(base._table_cache.values())) is setup.table("cpu")


def test_frame_setup_builds_nothing_on_a_device(monkeypatch):
    """``frame_setup`` alone packs no terrain and builds no table; its
    keywords are read-only; ``max_hits`` overrides the depth rule."""
    monkeypatch.setattr(base, "_table_cache", {})
    params, terrain = _scene(0.65)
    setup = base.frame_setup(params, terrain)
    assert not base._table_cache and not terrain._pack_cache
    assert (setup.max_hits, base.frame_setup(params, terrain, 3).max_hits) == (4, 3)
    assert setup.alt0 == params.view.position.abs_altitude(terrain)
    with pytest.raises(TypeError):
        setup.kw["n_terr"] = 1
    assert setup.kw["n_terr"] == setup.n_terr and setup.kw["terrain_alpha"] == 0.65
