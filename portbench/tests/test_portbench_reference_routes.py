"""The reference's routes for the frames ``gen`` renders on one card beyond
opaque terrain without objects: each against the program's plain path, the
control on each, and the harness's dispatch of the three generators."""

from types import SimpleNamespace

import pytest
import torch

from portbench import compare, harness, scene
from portbench.reference import Reference
from portbench.reference.frozen.generators import rectilinear_routes
from portbench.reference.lowp import lower_precision
from portbench.tests.conftest import SMALL

# the cell whose limits the control has to fail
CELL = "objects_1080p.rect_tilt0_sector"

# route -> (configuration, generator, tilt, with its objects, the function of
# rectilinear_routes the reference renders it by, or None)
ROUTES = {
    "rect_tilt0_objects": ("objects_1080p", "Rectilinear", 0.0, True, "shared_column_core"),
    "rect_tilt0_translucent": ("translucent_1080p", "Rectilinear", 0.0, False,
                               "multi_hit_shared_core"),
    "rect_tilt1_objects": ("objects_1080p", "Rectilinear", 1.0, True, "rectilinear_core"),
    "rect_tilt1_translucent": ("translucent_1080p", "Rectilinear", 1.0, True,
                               "rectilinear_core"),
    "interp": ("headline_1080p", "InterpolatingRectilinear", 0.0, False, None),
    "interp_objects": ("objects_1080p", "InterpolatingRectilinear", 0.0, True, None),
}


def _frame(route: str, tmp_path, direction: float = 45.0):
    """(keys, tiles, frame dict) of ``route`` at the tests' size, its
    objects where the configuration's rules stand them."""
    name, generator, tilt, with_objects, _ = ROUTES[route]
    bench = harness.load_json(harness.BENCHMARK)
    entry = {c["name"]: c for c in bench["configs"]}[name]
    config = harness.shrunk(harness.load_json(harness.ROOT / entry["file"]), SMALL)
    keys, tiles = scene.make_tiles(config, "cpu")
    objects = None
    if with_objects:
        scene.write_texture(tmp_path / "checker64.png")
        objects = harness.scene_objects(config, keys, tiles, tmp_path / "checker64.png", "cpu")
    return keys, tiles, scene.frame_dict(config["scene"], direction, tilt, generator, objects)


def _numbers(result, ref) -> dict:
    return compare.frame_numbers(result.image, compare.host_fields(result.hits), ref.image,
                                 compare.host_fields(ref.hits))


@pytest.mark.parametrize("route", ROUTES)
def test_the_route_equals_the_programs_plain_path(route, tmp_path, monkeypatch):
    """On the CPU the program runs its plain paths: the reference renders the
    frame by the route named, with the program's hit depth, and every number
    reads 0; the frame holds terrain hits, and object hits where it has
    objects."""
    keys, tiles, frame = _frame(route, tmp_path)
    taken = []
    fn = ROUTES[route][4]
    if fn is not None:
        inner = getattr(rectilinear_routes, fn)
        monkeypatch.setattr(rectilinear_routes, fn,
                            lambda *a, **k: taken.append(fn) or inner(*a, **k))
    program = harness.Program()
    terrain = scene.build_terrain(program.Terrain, program.Tile, keys, tiles)
    served = program.render(program.lower(frame, terrain), terrain, torch.device("cpu"))
    ref = Reference(keys, tiles, "cpu")
    want = ref.render(frame)
    ref.close()
    assert taken == ([fn] if fn else [])
    assert served.hits.key.shape == want.hits.key.shape
    numbers = _numbers(served, want)
    assert all(numbers[k] == 0.0 for k in compare.NUMBERS), numbers
    valid, kind = want.hits.valid, want.hits.kind
    assert bool((valid & (kind == 0)).any())
    assert bool((valid & (kind == 1)).any()) == ROUTES[route][3]


@pytest.mark.parametrize("route", ROUTES)
def test_the_control_is_called_wrong_on_each_route(route, tmp_path):
    """The reference with its table, terrain samples and marched rays in
    bfloat16 fails the new cell's limits on every new route."""
    keys, tiles, frame = _frame(route, tmp_path, direction=40.0)
    limits = harness.find_cell(harness.load_json(harness.BENCHMARK), CELL)[4]
    ref = Reference(keys, tiles, "cpu")
    want = ref.render(frame)
    with lower_precision():
        low = ref.render(frame)
    ref.close()
    numbers = _numbers(low, want)
    assert not compare.judge(numbers, limits), numbers


@pytest.mark.parametrize("generator,device,route", [
    ("Rectilinear", "cpu", "rect.render_rectilinear"),
    ("Rectilinear", "cuda", "rect.render_rectilinear"),
    ("InterpolatingRectilinear", "cpu", "interp.render_interpolating"),
    ("InterpolatingRectilinear", "cuda", "interp.render_interpolating"),
    ("Fast", "cpu", "fast.render_fast"),
    ("Fast", "cuda", "fast.render_fast_streamed"),
])
def test_program_render_takes_gens_route(generator, device, route):
    """``Program.render`` sends each generator where ``gen`` sends it
    (cli.py:134-149): Rectilinear and InterpolatingRectilinear to their
    renders, Fast on a card to the render of 8 bands, off a card to
    ``render_fast``."""
    program = harness.Program()
    calls = []

    def recorder(name):
        return lambda *args, **kwargs: calls.append((name, args, kwargs)) or name

    program.rect = SimpleNamespace(render_rectilinear=recorder("rect.render_rectilinear"))
    program.interp = SimpleNamespace(
        render_interpolating=recorder("interp.render_interpolating"))
    program.fast = SimpleNamespace(render_fast=recorder("fast.render_fast"),
                                   render_fast_streamed=recorder("fast.render_fast_streamed"))
    params = SimpleNamespace(output=SimpleNamespace(generator=generator))
    terrain, dev = object(), torch.device(device)
    assert program.render(params, terrain, dev) == route
    assert calls == [(route, (params, terrain, dev),
                      {"bands": 8} if route == "fast.render_fast_streamed" else {})]


def test_the_row_chunks_do_not_move_a_pixel(tmp_path, monkeypatch):
    """The reference marches more rows a chunk than the port does: a pixel's
    hits and color are the same, bit for bit, whatever chunk holds it."""
    keys, tiles, frame = _frame("rect_tilt0_objects", tmp_path)
    ref = Reference(keys, tiles, "cpu")
    whole = ref.render(frame)
    monkeypatch.setattr(rectilinear_routes, "auto_chunk_rows", lambda w, h, n: 5)
    chunked = ref.render(frame)
    ref.close()
    assert (whole.image == chunked.image).all()
    for f in ("valid", "key", "distance", "elevation", "path_length", "normal", "kind",
              "rgba"):
        assert torch.equal(getattr(whole.hits, f), getattr(chunked.hits, f)), f
