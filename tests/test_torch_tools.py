"""Parity of the PyTorch port's diagnostic subcommands with the JAX package:
``output-atm`` and ``output-elev-profile`` print the same text,
``output-ray-paths`` the same fan within 1e-3 m on the plain march, and the
host geodesic they walk agrees for all 8 Earth models, fed numpy arrays or
float64 tensors.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from atm_raytracer_tpu.models.earth import EarthModel as JEarth  # noqa: E402
from atm_raytracer_tpu.tools import atm_printer as j_atm  # noqa: E402
from atm_raytracer_tpu.tools import elev_profile as j_elev  # noqa: E402
from atm_raytracer_tpu.tools import ray_path as j_ray  # noqa: E402
from atm_raytracer_tpu_torch import cli  # noqa: E402
from atm_raytracer_tpu_torch.models.earth import EarthModel as TEarth  # noqa: E402
from atm_raytracer_tpu_torch.tools import atm_printer as t_atm  # noqa: E402
from atm_raytracer_tpu_torch.tools import elev_profile as t_elev  # noqa: E402
from atm_raytracer_tpu_torch.tools import ray_path as t_ray  # noqa: E402
from fixtures import make_terrain_folder  # noqa: E402
from test_torch_terrain import EARTH_CONFIGS, _ids  # noqa: E402
from torch_parity import cuda_device  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def terrain_dir(tmp_path_factory):
    return make_terrain_folder(tmp_path_factory.mktemp("torch_tools"),
                               tiles=((49, 21), (49, 22)), n=241)


def _write_config(tmp_path, terrain_dir, **extra):
    cfg = {
        "scene": {"terrain_folder": str(terrain_dir)},
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Absolute": 400.0}},
                 "frame": {"direction": 45.0, "fov": 20.0, "max_distance": 20000.0}},
        "simulation_step": 50.0,
        "output": {"width": 64, "height": 48},
        **extra,
    }
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _stdout(run, args, capsys):
    assert run(args) == 0
    return capsys.readouterr().out


ATM_CASES = {
    "us76": ({}, dict(min_alt=0.0, max_alt=12000.0, step=250.0, celsius=False)),
    "celsius": ({}, dict(min_alt=-100.0, max_alt=300.0, step=0.2, celsius=True)),
    "humidity": ({"atmosphere": {
        "temperature_fixed_point": {"altitude": 0.0, "temperature": 288.15},
        "humidity": {"points": [[0.0, 0.8], [2000.0, 0.2]]}}},
        dict(min_alt=0.0, max_alt=3000.0, step=125.0, celsius=False)),
    "spline": ({"atmosphere": {
        "first_temperature_function": {"Spline": {
            "boundary_condition": "Natural",
            "points": [[0.0, 288.0], [500.0, 290.0], [1500.0, 282.0]]}},
        "next_functions": [{"altitude": 1500.0,
                            "function": {"Linear": {"gradient": -0.0065}}}]}},
        dict(min_alt=0.0, max_alt=4000.0, step=50.0, celsius=False)),
}


@pytest.mark.parametrize("case", list(ATM_CASES))
def test_output_atm_matches_jax(case, terrain_dir, tmp_path, capsys):
    extra, flags = ATM_CASES[case]
    args = argparse.Namespace(input=_write_config(tmp_path, terrain_dir, **extra), **flags)
    want = _stdout(j_atm.run, args, capsys)
    assert _stdout(t_atm.run, args, capsys) == want
    assert len(want.splitlines()) > 10


@pytest.mark.parametrize("model", ["SimpleSphere", "Wgs84", "FlatDistorted",
                                   "AzimuthalEquidistant"])
@pytest.mark.parametrize("azim", [0.0, 45.0, 250.0])
def test_output_elev_profile_matches_jax(model, azim, terrain_dir, tmp_path, capsys):
    args = argparse.Namespace(
        input=_write_config(tmp_path, terrain_dir, earth_shape=model),
        azim=azim, step=137.0, cutoff=30000.0,
    )
    want = _stdout(j_elev.run, args, capsys)
    got = _stdout(t_elev.run, args, capsys)
    assert got == want


RAY_CASES = {
    "defaults": ({}, {}),
    "cutoff_100km": ({}, dict(height=100.0, min_ang=-0.2, max_ang=0.3,
                              angle_step=0.05, cutoff=100000.0, output_step=1000.0)),
    "flat": ({"earth_shape": "FlatDistorted"}, dict(height=50.0, cutoff=20000.0,
                                                    output_step=500.0)),
}
RAY_DEFAULTS = dict(height=2.0, min_ang=-1.0, max_ang=1.0, angle_step=0.1,
                    ray_step=50.0, cutoff=10000.0, output_step=50.0)


def _table(text):
    return np.asarray([[float(v) for v in ln.split()] for ln in text.splitlines()])


@pytest.mark.parametrize("case", list(RAY_CASES))
def test_output_ray_paths_matches_jax(case, terrain_dir, tmp_path, capsys):
    extra, flags = RAY_CASES[case]
    args = argparse.Namespace(input=_write_config(tmp_path, terrain_dir, **extra),
                              device="cpu", **{**RAY_DEFAULTS, **flags})
    want = _stdout(j_ray.run, args, capsys)
    got = _stdout(t_ray.run, args, capsys)
    assert [ln.split("\t")[0] for ln in got.splitlines()] == \
        [ln.split("\t")[0] for ln in want.splitlines()]
    j, t = _table(want), _table(got)
    assert j.shape == t.shape and j.shape[1] >= 2
    # 1e-3 m on the march, plus the 6 significant digits both print
    assert (np.abs(t - j) <= 1e-3 + 1e-5 * np.abs(j)).all(), np.abs(t - j).max()


def test_ray_paths_fan_heights_on_cpu(terrain_dir, tmp_path):
    args = argparse.Namespace(input=_write_config(tmp_path, terrain_dir),
                              device="cpu", **RAY_DEFAULTS)
    xs, h = t_ray.fan_heights(args, torch.device("cpu"))
    assert xs[0] == 0.0 and h.shape == (21, xs.shape[0])
    np.testing.assert_array_equal(h[:, 0], 2.0)
    assert (np.diff(h[:, -1]) > 0).all()  # steeper rays end higher


def test_cli_tools_run_as_subcommands(terrain_dir, tmp_path):
    cfg = _write_config(tmp_path, terrain_dir)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for args in (["output-atm", cfg, "-b", "10", "-s", "5"],
                 ["output-elev-profile", cfg, "-a", "45", "-c", "1000", "-s", "500"],
                 ["output-ray-paths", cfg, "-c", "200", "-o", "100", "--device", "cpu"]):
        proc = subprocess.run([sys.executable, "-m", "atm_raytracer_tpu_torch.cli", *args],
                              capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr
        rows = [ln for ln in proc.stdout.splitlines() if ln[:1].isdigit()]
        assert len(rows) == 3, proc.stdout


def test_ray_paths_refuse_cuda_without_a_card(monkeypatch, capsys, terrain_dir, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _write_config(tmp_path, terrain_dir)
    assert cli.main(["output-ray-paths", cfg, "--device", "cuda"]) == 1
    assert "is_available() is false" in capsys.readouterr().err


@pytest.mark.parametrize("cfg", EARTH_CONFIGS, ids=_ids)
def test_coords_at_dist_host_matches_jax(cfg):
    jm, tm = JEarth.from_config(cfg), TEarth.from_config(cfg)
    assert tm.to_config() == jm.to_config()
    az = np.linspace(-170.0, 190.0, 37)[:, None]
    dist = np.arange(0, 201)[None, :] * 1000.0
    for lat0, lon0 in ((49.5, 21.5), (-33.9, 151.2), (0.0, -179.9)):
        jlat, jlon = jm.coords_at_dist_host(lat0, lon0, az, dist)
        tlat, tlon = tm.coords_at_dist_host(lat0, lon0, az, dist)
        np.testing.assert_allclose(tlat, jlat, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tlon, jlon, rtol=0, atol=1e-12)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("cfg", EARTH_CONFIGS, ids=_ids)
def test_port_geodesy_follows_its_input_namespace(cfg, device, request):
    """The port's ``coords_at_dist_host`` and ``as_cartesian`` fed float64
    tensors return float64 tensors on the input's device, within 1e-12
    relative of the JAX package's on the same inputs; numpy inputs still
    give numpy arrays."""
    if device == "cuda":
        device = request.getfixturevalue("cuda_device")
    jm, tm = JEarth.from_config(cfg), TEarth.from_config(cfg)
    rng = np.random.default_rng(11)
    lat0, lon0 = 49.979439, 21.622839
    az = rng.uniform(0.0, 360.0, (40, 1))
    dist = rng.uniform(0.0, 300_000.0, (1, 30))
    elev = rng.uniform(-100.0, 3000.0, (40, 30))
    jlat, jlon = jm.coords_at_dist_host(lat0, lon0, az, dist)
    want = (jlat, jlon, jm.as_cartesian(jlat, jlon, elev))
    lat, lon = tm.coords_at_dist_host(lat0, lon0, az, dist)
    got = (lat, lon, tm.as_cartesian(lat, lon, elev))
    assert all(type(x) is np.ndarray for x in got)

    def f64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    t_lat, t_lon = tm.coords_at_dist_host(lat0, lon0, f64(az), f64(dist))
    t_got = (t_lat, t_lon, tm.as_cartesian(t_lat, t_lon, f64(elev)))
    for t, n, w in zip(t_got, got, want):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
        assert t.device == torch.device(device)
        np.testing.assert_allclose(n, w, rtol=1e-12, atol=0.0)
        np.testing.assert_allclose(t.cpu().numpy(), w, rtol=1e-12, atol=0.0)
