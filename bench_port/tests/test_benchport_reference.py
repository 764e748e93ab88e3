"""The plain references against scalar loops on tiny panels, and the
Newton step on a quadratic."""

import math

import pytest
import torch

from reference import _newton, arima, garch, holtwinters, transforms

F64 = torch.float64


def _series(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g, dtype=F64)


def test_arima_css_matches_loop():
    y = torch.cumsum(_series(40, 1), 0)
    c, phi, theta = 0.05, 0.4, -0.3
    yd = [float(y[t + 1] - y[t]) for t in range(39)]
    e_prev, css = 0.0, 0.0
    for t in range(1, len(yd)):
        e = yd[t] - c - phi * yd[t - 1] - theta * e_prev
        css += e * e
        e_prev = e
    n = len(yd) - 1
    want = 0.5 * n * (math.log(2 * math.pi * css / n) + 1)
    prep = arima.prepare(y[None], F64, F64)
    f = prep.objective(prep.eligible)
    got = f(torch.tensor([[[c, phi, theta]]], dtype=F64))[0, 0]
    assert math.isclose(float(got), want, rel_tol=1e-12)


def test_garch_nll_matches_loop():
    r = _series(60, 2)
    r[:5] = float("nan")
    r[-3:] = float("nan")
    om, al, be = 0.1, 0.1, 0.8
    x = [float(v) for v in r[5:-3]]
    mean = sum(x) / len(x)
    h0 = sum((v - mean) ** 2 for v in x) / len(x)
    h, nll, prev = h0, 0.0, h0
    for v in x:
        h = om + al * prev + be * h
        nll += math.log(2 * math.pi * h) + v * v / h
        prev = v * v
    prep = garch.prepare(r[None], F64, F64)
    f = prep.objective(prep.eligible)
    v = garch.to_free(torch.tensor([[om, al, be]], dtype=F64))
    got = f(v[None])[0, 0]
    assert math.isclose(float(got), 0.5 * nll, rel_tol=1e-12)
    back = garch.to_params(v)
    assert torch.allclose(back, torch.tensor([[om, al, be]], dtype=F64))


def test_holtwinters_sse_matches_loop():
    m, lead = 4, 3
    y = 10 + _series(30, 3)
    y[:lead] = float("nan")
    a, b, g = 0.3, 0.2, 0.4
    x = [float(v) for v in y[lead:]]
    lev = sum(x[:m]) / m
    tr = (sum(x[m:2 * m]) / m - lev) / m
    seas = [v - lev for v in x[:m]]
    sse = 0.0
    for i, v in enumerate(x):
        s = seas[i % m]
        pred = lev + tr + s
        if i >= m:
            sse += (v - pred) ** 2
        nl = a * (v - s) + (1 - a) * (lev + tr)
        tr = b * (nl - lev) + (1 - b) * tr
        seas[i % m] = g * (v - nl) + (1 - g) * s
        lev = nl
    prep = holtwinters.Prepared(y[None], F64, F64, m)
    f = prep.objective(prep.eligible)
    got = f(holtwinters.to_free(torch.tensor([[[a, b, g]]], dtype=F64)))
    assert math.isclose(float(got[0, 0]), sse, rel_tol=1e-12)


def test_fill_difference_autocorr():
    x = torch.tensor([[float("nan"), 1.0, float("nan"), float("nan"), 4.0,
                       5.0, float("nan")]], dtype=F64)
    f = transforms.fill_linear(x)
    want = [float("nan"), 1.0, 2.0, 3.0, 4.0, 5.0, float("nan")]
    for got, w in zip(f[0].tolist(), want):
        assert (math.isnan(got) and math.isnan(w)) or got == w
    d = transforms.difference(f)
    assert d[0, 2:6].tolist() == [1.0, 1.0, 1.0, 1.0]
    assert math.isnan(float(d[0, 0])) and math.isnan(float(d[0, 1]))
    z = torch.tensor([[1.0, 3.0, float("nan"), 2.0, 6.0]], dtype=F64)
    vals = [1.0, 3.0, 2.0, 6.0]
    mean = sum(vals) / 4
    dd = [v - mean if not math.isnan(v) else 0.0 for v in z[0].tolist()]
    den = sum(v * v for v in dd)
    r1 = sum(dd[t] * dd[t - 1] for t in range(1, 5)) / den
    r2 = sum(dd[t] * dd[t - 2] for t in range(2, 5)) / den
    got = transforms.autocorr(z, 2, F64)[0]
    assert torch.allclose(got, torch.tensor([r1, r2], dtype=F64))


def test_newton_gain_on_a_quadratic():
    A = torch.tensor([[3.0, 1.0], [1.0, 2.0]], dtype=F64)
    b = torch.tensor([1.0, -2.0], dtype=F64)

    def f(V):
        return 0.5 * torch.einsum("sbi,ij,sbj->sb", V, A, V) \
            - (V * b).sum(-1) + 10.0

    v = torch.tensor([[0.5, -0.5], [1.0, -1.0]], dtype=F64)
    f0, fall = _newton.gain(f, v, 1e-3)
    xs = torch.linalg.solve(A, b)
    fmin = float(f(xs[None, None])[0, 0])
    assert torch.allclose(fall, f0 - fmin, rtol=1e-8, atol=1e-10)
    v2, fv = _newton.minimize(f, v, 1e-3, 2)
    assert torch.allclose(v2, xs.expand(2, 2), atol=1e-8)
    # a far point moves at most RADIUS in a coordinate a step
    far = torch.tensor([[10.0, -12.0]], dtype=F64)
    _, _, v3 = _newton.step(f, far, 1e-3)
    assert float((v3 - far).abs().max()) <= _newton.RADIUS + 1e-12


@pytest.mark.parametrize("model", [arima, garch])
def test_short_rows_not_eligible(model):
    y = torch.full((2, 20), float("nan"), dtype=F64)
    y[0, :] = torch.cumsum(_series(20, 4), 0)
    y[1, 15:] = 1.0  # five values only
    prep = model.prepare(y, F64, F64)
    assert prep.eligible.tolist() == [True, False]
