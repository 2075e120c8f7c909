"""Parity of the PyTorch port's ray march with the JAX package.

The same rays and the same refraction table (carried over by
``interop.table_from_arrays``) go through ``atm_raytracer_tpu.physics.ray``
and its port; the JAX Pallas march kernel runs in interpret mode.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from atm_raytracer_tpu.experimental.march_pallas import march_nodes_pallas  # noqa: E402
from atm_raytracer_tpu.physics import ray as JR  # noqa: E402
from atm_raytracer_tpu.physics.atmosphere import Atmosphere, us_76  # noqa: E402
from atm_raytracer_tpu_torch import interop  # noqa: E402
from atm_raytracer_tpu_torch.physics import atmosphere as TA  # noqa: E402
from atm_raytracer_tpu_torch.physics import ray as TR  # noqa: E402

R = 6_371_000.0


@pytest.fixture(scope="module")
def tables():
    jt = JR.RefractionTable.build(Atmosphere(us_76()), 530e-9)
    tt = interop.table_from_arrays(
        np.asarray(jt.h0), np.asarray(jt.inv_dh), np.asarray(jt.values), jt.poly, "cpu"
    )
    return jt, tt


def test_atmosphere_matches_jax():
    hs = np.linspace(-1500.0, 60000.0, 997)
    ja, ta = Atmosphere(us_76()), TA.Atmosphere(TA.us_76())
    np.testing.assert_array_equal(ta.dlnn_dh(hs, 530e-9), ja.dlnn_dh(hs, 530e-9))
    np.testing.assert_array_equal(ta.temperature(hs), ja.temperature(hs))


def test_table_build_matches_jax(tables):
    jt, _ = tables
    own = TR.RefractionTable.build(TA.Atmosphere(TA.us_76()), 530e-9, device="cpu")
    assert own.poly == jt.poly
    np.testing.assert_array_equal(own.values.numpy(), np.asarray(jt.values))
    np.testing.assert_array_equal(own.pairs.numpy(), np.asarray(jt.pairs))


def test_lookup_and_poly_match_jax(tables):
    jt, tt = tables
    hs = np.random.default_rng(0).uniform(-2500.0, 21000.0, 4001).astype(np.float32)
    np.testing.assert_allclose(
        tt.lookup(torch.from_numpy(hs)).numpy(),
        np.asarray(jt.lookup(jnp.asarray(hs))), rtol=1e-5,
    )
    np.testing.assert_allclose(
        TR.eval_l_poly(tt.poly, torch.from_numpy(hs)).numpy(),
        np.asarray(JR.eval_l_poly(jt.poly, jnp.asarray(hs))), rtol=1e-5,
    )


@pytest.mark.parametrize("l_form", ["poly", "table"])
@pytest.mark.parametrize("coarse", [1, 8, 16])
@pytest.mark.parametrize("straight", [False, True])
@pytest.mark.parametrize("sphere", [True, False])
def test_march_rays_matches_jax(tables, sphere, straight, coarse, l_form):
    jt, tt = tables
    if l_form == "table":
        jt = dataclasses.replace(jt, poly=None)
        tt = dataclasses.replace(tt, poly=None)
    elev = np.deg2rad(np.array([-0.5, -0.12, 0.0, 0.1, 0.8, 2.0])).astype(np.float32)
    step, n = 50.0, 320
    jshape = JR.EarthShape(R) if sphere else JR.FLAT
    tshape = TR.EarthShape(R) if sphere else TR.FLAT
    jh, jp = JR.march_rays(100.0, jnp.asarray(elev), step, n, jshape, jt,
                           straight, coarse=coarse)
    th, tp = TR.march_rays(100.0, torch.from_numpy(elev), step, n, tshape, tt,
                           straight, coarse=coarse)
    assert th.shape == (elev.size, n + 1) and tp.shape == th.shape
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)


@pytest.mark.parametrize("l_form", ["poly", "table"])
@pytest.mark.parametrize("sphere", [True, False])
@pytest.mark.parametrize("n, coarse, n_rays", [(330, 16, 5), (330, 16, 1), (57, 1, 1)],
                         ids=["ragged_tail", "one_ray_ragged", "one_ray_c1"])
def test_march_rays_ragged_and_single_ray_match_jax(tables, n, coarse, n_rays, sphere,
                                                    l_form):
    """N not a multiple of C (sample N from the last window's Hermite at
    j = N - (Nc-1)·C), one ray, and C = 1 (the nodes are the samples)."""
    jt, tt = tables
    if l_form == "table":
        jt = dataclasses.replace(jt, poly=None)
        tt = dataclasses.replace(tt, poly=None)
    elev = np.deg2rad(np.linspace(-0.4, 1.2, n_rays) if n_rays > 1
                      else np.array([0.05])).astype(np.float32)
    jshape = JR.EarthShape(R) if sphere else JR.FLAT
    tshape = TR.EarthShape(R) if sphere else TR.FLAT
    jh, jp = JR.march_rays(100.0, jnp.asarray(elev), 50.0, n, jshape, jt, False,
                           coarse=coarse)
    th, tp = TR.march_rays(100.0, torch.from_numpy(elev), 50.0, n, tshape, tt, False,
                           coarse=coarse)
    assert th.shape == (n_rays, n + 1) and tp.shape == th.shape
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    # the ragged tail's last sample is the last window's Hermite, not a node
    if n % coarse:
        h_nodes, v_nodes = TR.march_nodes_plain(
            torch.full((n_rays,), 100.0), TR.initial_slope(
                torch.full((n_rays,), 100.0), torch.from_numpy(elev), tshape),
            TR._f32(50.0 * coarse), -(-n // coarse), tt, tshape.radius)
        fill = TR.hermite_fill(h_nodes, v_nodes, TR._f32(50.0 * coarse), coarse, n)
        assert torch.equal(fill.t(), th)


@pytest.mark.parametrize("sphere", [True, False])
def test_plain_nodes_match_pallas_interpret(tables, sphere):
    jt, tt = tables
    radius = R if sphere else None
    elev = np.deg2rad(np.array([-0.5, -0.1, 0.0, 0.1, 1.0])).astype(np.float32)
    alt = np.full_like(elev, 100.0)
    shape = TR.EarthShape(radius)
    v0 = TR.initial_slope(torch.from_numpy(alt), torch.from_numpy(elev), shape)
    hp, vp = march_nodes_pallas(jnp.asarray(alt), jnp.asarray(v0.numpy()), 400.0,
                                120, jt.poly, radius, interpret=True)
    th, tv = TR.march_nodes_plain(torch.from_numpy(alt), v0, 400.0, 120, tt, radius)
    np.testing.assert_allclose(th.numpy(), np.asarray(hp), atol=2e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(vp), atol=1e-6)


def test_march_nodes_wrapper_takes_plain_on_cpu(tables):
    _, tt = tables
    alt = torch.full((7,), 50.0)
    v0 = torch.linspace(-0.01, 0.02, 7)
    launches = TR._kernels.MARCH.launches
    h, v = TR.march_nodes(alt, v0, 800.0, 30, tt, R)
    hp, vp = TR.march_nodes_plain(alt, v0, 800.0, 30, tt, R)
    assert torch.equal(h, hp) and torch.equal(v, vp)
    assert TR._kernels.MARCH.launches == launches  # no kernel on the CPU


@pytest.mark.parametrize("coarse", [1, 16])
@pytest.mark.parametrize("sphere", [True, False])
def test_march_rays_on_cpu_launches_no_kernel(tables, sphere, coarse):
    """On CPU tensors march_rays is the plain path (the kernel's oracle on
    the card, ``plain=True``) and launches nothing."""
    _, tt = tables
    shape = TR.EarthShape(R) if sphere else TR.FLAT
    elev = torch.deg2rad(torch.linspace(-0.3, 0.9, 9))
    launches = TR._kernels.MARCH.launches
    h, p = TR.march_rays(40.0, elev, 50.0, 330, shape, tt, False, coarse=coarse)
    hp, pp = TR.march_rays(40.0, elev, 50.0, 330, shape, tt, False, coarse=coarse,
                           plain=True)
    assert TR._kernels.MARCH.launches == launches
    assert torch.equal(h, hp) and torch.equal(p, pp)


def test_poly_rows_built_once_per_table(tables):
    _, tt = tables
    rows = tt.poly_rows()
    assert rows is tt.poly_rows()  # no rebuild, no second upload
    assert rows.shape == (len(tt.poly), 10) and rows.dtype == torch.float32
    for row, (lo, hi, coeffs) in zip(rows.tolist(), tt.poly):
        np.testing.assert_array_equal(
            np.float32(row), np.float32([lo, hi, max(hi - lo, 1e-30), *coeffs]))
    # a replaced table (another fit, another device) builds its own rows
    other = dataclasses.replace(tt, poly=tt.poly[:2])
    assert other.poly_rows().shape == (2, 10)
    assert tt.poly_rows() is rows
