"""K3's window cull (``ray_device.cuh::hull_clear``) through its PyTorch
mirror, ``generators/rectilinear.py::rule_hull_clear``, on hypothesis'
windows: the hull never skips a window that the plain test flags or in
which a sample dies. The rest of K3's CPU tests are in
test_torch_rect_scan.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
torch.set_num_threads(1)

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from atm_raytracer_tpu_torch.generators import rectilinear as TRect  # noqa: E402
from atm_raytracer_tpu_torch.physics import ray as TR  # noqa: E402


def _window_samples(h0, v0, h1, v1, c=16, dx=800.0):
    """The window's C + 1 fine samples as the scans compute them."""
    coeffs = TR.hermite_coeffs(c)
    vdx, v1dx = v0 * np.float32(dx), v1 * np.float32(dx)
    t = [torch.tensor(x, dtype=torch.float32) for x in (h0, vdx, h1, v1dx)]
    return torch.stack([TR.hermite_plane(*t, coeffs, j) for j in range(c + 1)]), t


_STATE = (st.floats(-900.0, 2.0e4, width=32) | st.floats(-3000.0, 2.0e4, width=32)
          | st.sampled_from([np.nan, np.inf, -np.inf]))
_SMALL = st.floats(-2.0 ** -10, 2.0 ** -10, width=32) | st.just(0.0)


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(h0=_STATE, v0=st.floats(-3.0, 3.0, width=32) | _SMALL | st.just(np.nan),
       dh=st.floats(-3000.0, 3000.0, width=32) | _SMALL,
       dv=st.floats(-1.0, 1.0, width=32) | _SMALL, data=st.data())
def test_hull_never_skips_a_flagged_or_dying_window(h0, v0, dh, dv, data):
    """Rule 2 on hypothesis' windows: when ``rule_hull_clear`` skips a
    window, no segment product of its samples against the terrain is
    negative (no flag at K = 1, no crossing at K > 1) and no sample j < C
    lies below DEATH_ALTITUDE. The terrain is drawn anywhere, or with its
    maximum a few ulps under the rule's own bound, where a rounding margin
    too thin would show (flat windows put the samples right at that bound)."""
    h1 = np.float32(h0 + dh) if np.isfinite(h0) else np.float32(h0)
    v1 = np.float32(v0 + dv)
    samples, (th0, tvdx, th1, tv1dx) = _window_samples(h0, v0, h1, v1)
    terr = torch.tensor(data.draw(st.lists(st.floats(-2.0e4, 2.0e4, width=32),
                                           min_size=17, max_size=17)), dtype=torch.float32)
    bound = (torch.minimum(torch.minimum(th0, th0 + tvdx * TRect.RULE_THIRD),
                           torch.minimum(th1 - tv1dx * TRect.RULE_THIRD, th1))
             - TRect.RULE_M_REL * (th0.abs() + th1.abs() + tvdx.abs() + tv1dx.abs()))
    if data.draw(st.booleans()) and bool(torch.isfinite(bound)):
        top = bound
        for _ in range(data.draw(st.integers(1, 64))):
            top = torch.nextafter(top, torch.tensor(-np.inf))
        terr = torch.minimum(terr, top)
        terr[data.draw(st.integers(0, 16))] = top
    skip = bool(TRect.rule_hull_clear(th0, tvdx, th1, tv1dx, terr.max()))
    if skip:
        d = samples - terr
        assert not bool((d[:-1] * d[1:] < 0.0).any())
        assert bool((d > 0.0).all())
        assert not bool((samples[:-1] < TR.DEATH_ALTITUDE).any())
