"""Parity of the PyTorch port's Earth models and terrain layer with JAX:
device geodesics for all 8 Earth models, tile readers, the tile stack, and
bilinear elevation + gradient normals."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from atm_raytracer_tpu.models.earth import EarthModel as JEarth  # noqa: E402
from atm_raytracer_tpu.terrain import dted as jdted, geotiff as jgeotiff  # noqa: E402
from atm_raytracer_tpu.terrain.sample import sample_terrain_data as j_sample  # noqa: E402
from atm_raytracer_tpu.terrain.store import Terrain as JTerrain, Tile as JTile  # noqa: E402
from atm_raytracer_tpu_torch import interop  # noqa: E402
from atm_raytracer_tpu_torch.models.earth import EarthModel as TEarth  # noqa: E402
from atm_raytracer_tpu_torch.terrain import dted as tdted, geotiff as tgeotiff  # noqa: E402
from atm_raytracer_tpu_torch.terrain.sample import sample_terrain_data as t_sample  # noqa: E402
from atm_raytracer_tpu_torch.terrain.store import Terrain as TTerrain, Tile as TTile  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402

LAT0, LON0 = 49.5, 21.5

EARTH_CONFIGS = [
    "SimpleSphere",
    {"Spherical": {"radius": 6_000_000.0}},
    {"Ellipsoid": {"a": 6_378_000.0, "b": 6_350_000.0}},
    "Wgs84",
    "AzimuthalEquidistant",
    "FlatDistorted",
    {"ObserverAe": {"proj_radius": 6_371_000.0}},
    "SimpleObserverAe",
]


def _ids(cfg):
    return cfg if isinstance(cfg, str) else next(iter(cfg))


@pytest.mark.parametrize("cfg", EARTH_CONFIGS, ids=_ids)
def test_geodesic_delta_matches_jax(cfg):
    jm, tm = JEarth.from_config(cfg), TEarth.from_config(cfg)
    assert tm.to_shape().radius == jm.to_shape().radius
    assert tm.distance_radius() == jm.distance_radius()
    az = np.linspace(-170.0, 190.0, 37).astype(np.float32)[:, None]
    dist = (np.arange(0, 201) * 1000.0).astype(np.float32)[None, :]
    jlat, jlon = jm.geodesic_delta(LAT0, LON0, jnp.asarray(az), jnp.asarray(dist))
    tlat, tlon = tm.geodesic_delta(LAT0, LON0, torch.from_numpy(az), torch.from_numpy(dist))
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tlon.numpy(), np.asarray(jlon), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfg", EARTH_CONFIGS, ids=_ids)
def test_basis_and_normal_offsets_match_jax(cfg):
    jm, tm = JEarth.from_config(cfg), TEarth.from_config(cfg)
    lat = np.linspace(-60.0, 70.0, 11).astype(np.float32)
    lon = np.linspace(-150.0, 170.0, 11).astype(np.float32)
    for j, t in zip(jm.world_directions(jnp.asarray(lat), jnp.asarray(lon), xp=jnp),
                    tm.world_directions(torch.from_numpy(lat), torch.from_numpy(lon))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    for j, t in zip(jm.world_directions(LAT0, LON0), tm.world_directions(LAT0, LON0)):
        np.testing.assert_array_equal(t, j)  # host f64 path
    for j, t in zip(jm.normal_offsets(jnp.asarray(lat)),
                    tm.normal_offsets(torch.from_numpy(lat))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_readers_match_jax(tmp_path):
    grid = (np.random.default_rng(0).integers(-400, 2500, (31, 41))).astype(np.int16)
    jdted.write_dted(tmp_path / "t.dt2", 49.0, -21.0, grid)
    jh, je = jdted.read_dted(tmp_path / "t.dt2")
    th, te = tdted.read_dted(tmp_path / "t.dt2")
    assert (th.origin_lat, th.origin_lon, th.n_lat, th.n_lon) == (
        jh.origin_lat, jh.origin_lon, jh.n_lat, jh.n_lon)
    np.testing.assert_array_equal(te, je)
    jgeotiff.write_geotiff(tmp_path / "N49W021.tif", grid)
    np.testing.assert_array_equal(tgeotiff.read_geotiff(tmp_path / "N49W021.tif"),
                                  jgeotiff.read_geotiff(tmp_path / "N49W021.tif"))
    assert tgeotiff.coords_from_name("x/S03E120.tif") == (-3, 120)


@pytest.fixture(scope="module")
def terrains(tmp_path_factory):
    """Both packages' stores over one folder: 3 of 4 tiles of a 2×2 block
    (a missing tile inside the box), one of them GeoTIFF."""
    d = tmp_path_factory.mktemp("torch_terrain")
    make_terrain_folder(d, tiles=((49, 21), (50, 21), (49, 22)), n=61)
    make_terrain_folder(d, tiles=((50, 22),), n=61, fmt="geotiff")
    return JTerrain.from_folder(d), TTerrain.from_folder(d)


def _sample_points():
    rng = np.random.default_rng(11)
    dlat = rng.uniform(-0.9, 1.6, (23, 41)).astype(np.float32)
    dlon = rng.uniform(-0.8, 1.7, (23, 41)).astype(np.float32)
    return dlat, dlon


def test_pack_layout_matches_jax(terrains):
    jt, tt = terrains
    box = ((48.7, 51.2), (20.6, 23.1))
    jp, tp = jt.pack(*box), tt.pack(*box, "cpu")
    assert (tp.lat_min, tp.lon_min, tp.n_rows, tp.n_cols) == (
        jp.lat_min, jp.lon_min, jp.n_rows, jp.n_cols)
    assert tp.tiles.dtype == torch.int16 and tp.tiles.shape[0] == 4
    np.testing.assert_array_equal(tp.rows_m1.numpy(), np.asarray(jp.rows_m1))
    assert tt.pack(*box, "cpu") is tp  # memoized per box and device
    assert tt.get_elev(49.3, 21.4) == jt.get_elev(49.3, 21.4)


@pytest.mark.parametrize("cfg", ["SimpleSphere", "Wgs84", "FlatDistorted",
                                 "AzimuthalEquidistant"], ids=_ids)
def test_sample_terrain_data_matches_jax(terrains, cfg):
    jt, tt = terrains
    box = ((48.7, 51.2), (20.6, 23.1))
    jp, tp = jt.pack(*box), tt.pack(*box, "cpu")
    dlat, dlon = _sample_points()
    je, jn = j_sample(jp, JEarth.from_config(cfg), jnp.asarray(dlat),
                      jnp.asarray(dlon), LAT0, LON0)
    te, tn = t_sample(tp, TEarth.from_config(cfg), torch.from_numpy(dlat),
                      torch.from_numpy(dlon), LAT0, LON0)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-3)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)


def test_float_mosaic_through_interop():
    """A non-integer mosaic packs as f32 in both packages; the JAX pack's
    arrays carried over by ``interop.pack_from_arrays`` sample identically."""
    rng = np.random.default_rng(5)
    jt = JTerrain()
    for la, lo in ((49, 21), (49, 22)):
        jt.add_tile(JTile(la, lo, rng.uniform(0.0, 900.0, (21, 21)).astype(np.float32)))
    jp = jt.pack((49.1, 49.9), (21.1, 22.9))
    assert jp.quad is None
    tp = interop.pack_from_arrays(
        np.asarray(jp.tiles), np.asarray(jp.rows_m1), np.asarray(jp.cols_m1),
        jp.lat_min, jp.lon_min, jp.n_rows, jp.n_cols, "cpu",
    )
    own = TTerrain()
    for la, lo in ((49, 21), (49, 22)):
        own.add_tile(TTile(la, lo, jt._loaded[(la, lo)].elev))
    own_pack = own.pack((49.1, 49.9), (21.1, 22.9), "cpu")
    assert torch.equal(own_pack.tiles, tp.tiles)
    dlat, dlon = _sample_points()
    dlat, dlon = dlat * 0.4, dlon * 0.9 + 0.5
    model = "SimpleSphere"
    je, jn = j_sample(jp, JEarth.from_config(model), jnp.asarray(dlat),
                      jnp.asarray(dlon), LAT0, LON0)
    te, tn = t_sample(tp, TEarth.from_config(model), torch.from_numpy(dlat),
                      torch.from_numpy(dlon), LAT0, LON0)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-3)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
