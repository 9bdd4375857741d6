"""The port's SPOT variants against the JAX package's, on the CPU.

``back_mean``, ``dSPOT``, ``biSPOT`` and ``bidSPOT`` are numpy/scipy copies
of ``mtad_gat_tpu/inference/spot.py``, so on the same seeded series they give
the same numbers: thresholds within rtol 1e-9 (the same float64 arithmetic
in the same order; the bound only allows for a libm that differs between
two imports, which does not happen in one process) and alarms equal.
``dSPOT.step`` replays ``dSPOT.run`` exactly, and the plotting helper draws
the same artists, counted by kind, under matplotlib's Agg backend.
"""

import numpy as np
import pytest

from mtad_gat_tpu.inference import spot as jax_spot
from mtad_gat_tpu_torch.inference import spot as port_spot

RTOL = 1e-9


def _stream(seed, n_init=1500, n=160, spike=True):
    rng = np.random.default_rng(seed)
    drift = np.cumsum(rng.normal(0.0, 0.02, n_init + n))
    vals = rng.gamma(2.0, 1.0, n_init + n) + drift
    if spike:
        vals[n_init + 60:n_init + 66] += 9.0     # an anomaly above the drift
        vals[n_init + 110:n_init + 114] -= 6.0   # and one below it
    return vals[:n_init], vals[n_init:]


def _run(mod, cls, kw, init, stream, with_alarm):
    s = getattr(mod, cls)(**kw)
    s.fit(init, stream)
    s.initialize()
    return s, s.run(with_alarm=with_alarm)


@pytest.mark.parametrize("d", [1, 10, 50])
def test_back_mean_equals_jax(d):
    x = np.random.default_rng(d).gamma(2.0, 1.0, 300)
    got, want = port_spot.back_mean(x, d), jax_spot.back_mean(x, d)
    assert got.shape == (300 - d + 1,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cls,kw", [
    ("dSPOT", dict(q=1e-3, depth=10)),
    ("dSPOT", dict(q=1e-3, depth=50)),
    ("biSPOT", dict(q=1e-3)),
    ("bidSPOT", dict(q=1e-3, depth=10)),
])
@pytest.mark.parametrize("with_alarm", [True, False], ids=["alarms", "no_alarms"])
def test_variant_run_equals_jax(cls, kw, with_alarm):
    init, stream = _stream(3)
    port, got = _run(port_spot, cls, kw, init, stream, with_alarm)
    jax, want = _run(jax_spot, cls, kw, init, stream, with_alarm)
    assert got.keys() == want.keys()
    for key in want:
        if key == "alarms":
            assert got[key] == want[key]
        else:
            np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                                       rtol=RTOL, err_msg=key)
    if with_alarm:
        assert got["alarms"], "the injected anomalies raise no alarm"
    # the fitted state, attribute for attribute (state files pickle it)
    assert vars(port).keys() == vars(jax).keys()
    for name in ("init_threshold", "extreme_quantile", "Nt", "n"):
        a, b = getattr(port, name), getattr(jax, name)
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            np.testing.assert_allclose(list(a.values()), list(b.values()), rtol=RTOL)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=name)


def test_dspot_step_replays_run_exactly():
    """dSPOT.step is the incremental body of dSPOT.run: alarms and
    drift-adjusted thresholds the same point for point, the drift window
    frozen during alarms included; and equal to the JAX package's steps."""
    init, stream = _stream(7, n_init=2000, n=300)
    batch = port_spot.dSPOT(q=1e-3, depth=50)
    batch.fit(init, stream)
    batch.initialize()
    want = batch.run(with_alarm=True)

    steps = {}
    for name, mod in (("port", port_spot), ("jax", jax_spot)):
        inc = mod.dSPOT(q=1e-3, depth=50)
        inc.fit(init, np.empty(0))
        inc.initialize()
        alarms, ths = [], []
        for i, x in enumerate(stream):
            if inc.step(float(x)):
                alarms.append(i)
            ths.append(inc.last_threshold)
        steps[name] = (alarms, ths)
    alarms, ths = steps["port"]
    assert alarms == list(want["alarms"]) and alarms
    np.testing.assert_array_equal(ths, want["thresholds"])
    assert steps["jax"][0] == alarms
    np.testing.assert_allclose(steps["jax"][1], ths, rtol=RTOL)


@pytest.mark.parametrize("cls,kw,lines", [
    ("SPOT", dict(q=1e-3), 2),
    ("dSPOT", dict(q=1e-3, depth=10), 2),
    ("biSPOT", dict(q=1e-3), 3),
    ("bidSPOT", dict(q=1e-3, depth=10), 3),
])
def test_plot_draws_the_jax_artists(cls, kw, lines):
    """``plot`` (``_plot_run``): the series, one dashed line per threshold
    series and the alarm scatter, in that order, as the JAX package draws."""
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    init, stream = _stream(5)
    kinds = {}
    for name, mod in (("port", port_spot), ("jax", jax_spot)):
        s = getattr(mod, cls)(**kw)
        s.fit(init, stream)
        if cls == "SPOT":
            s.initialize(level=0.98)
        else:
            s.initialize()
        res = s.run(with_alarm=True)
        plt.figure()
        try:
            artists = s.plot(res)
            kinds[name] = [type(a).__name__ for a in artists]
            if name == "port":
                assert artists[0].get_ydata().shape == stream.shape
                assert all(a.get_linestyle() == "--" for a in artists[1:lines])
                assert plt.gca().get_xlim() == (0, stream.size)
        finally:
            plt.close("all")
    assert kinds["port"] == kinds["jax"]
    assert kinds["port"].count("Line2D") == lines
    assert kinds["port"][-1] == "PathCollection"
