"""The port's client-side endpoint health cache (``serving.health``)
against the reference's (``tests/test_health.py``), case for case.

The cache is pure host code, so the bar is equality: the same seed gives
the same cooldown schedule, and the same calls under the same injected
clock give the same ``order()`` and the same snapshot in both packages.
Every mutating call takes an explicit ``now``, so no test sleeps.
"""

import json

import numpy as np
import pytest

from spark_timeseries_tpu.serving import health as rhealth
from spark_timeseries_tpu_torch.serving import health
from spark_timeseries_tpu_torch.serving.health import (EndpointHealthCache,
                                                       cooldown_schedule)

A = ("127.0.0.1", 9001)
B = ("127.0.0.1", 9002)
C = ("127.0.0.1", 9003)
KEY_A = "127.0.0.1:9001"


def _cache(mod=health, **kw):
    kw.setdefault("seed", 7)
    kw.setdefault("failure_threshold", 3)
    return mod.EndpointHealthCache([A, B, C], **kw)


# -- equality with the reference ----------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 11, 2 ** 31 - 1])
@pytest.mark.parametrize("ep", [A, B, ("10.1.2.3", 65535)])
def test_cooldown_schedule_equals_the_reference(seed, ep):
    for kw in ({}, {"base_s": 0.1, "max_s": 2.0}):
        assert (cooldown_schedule(seed, ep, 9, **kw)
                == rhealth.cooldown_schedule(seed, ep, 9, **kw))


def _script(seed):
    """A seeded sequence of outcome records and order queries."""
    rng = np.random.default_rng(seed)
    eps = [A, B, C]
    out, now = [], 0.0
    for _ in range(60):
        now += float(rng.uniform(0.0, 0.4))
        ep = eps[int(rng.integers(0, 3))]
        op = int(rng.integers(0, 6))
        if op == 0:
            out.append(("record_failure", (ep,), {"now": now}))
        elif op == 1:
            out.append(("record_success",
                        (ep, float(rng.uniform(0.001, 0.3))), {"now": now}))
        elif op == 2:
            out.append(("record_redirect", (ep,), {"now": now}))
        elif op == 3:
            out.append(("set_primary", (ep,), {}))
        else:
            out.append(("order", (), {"write": bool(op == 5), "now": now}))
        out.append(("snapshot", (), {"now": now}))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_order_and_snapshot_equal_the_reference_under_a_fixed_clock(seed):
    port = _cache(seed=seed, failure_threshold=2)
    ref = _cache(rhealth, seed=seed, failure_threshold=2)
    for name, args, kw in _script(seed):
        got = getattr(port, name)(*args, **kw)
        want = getattr(ref, name)(*args, **kw)
        assert got == want, (name, args, kw)
        assert port.believed_primary() == ref.believed_primary()


# -- the reference's cases on the port ----------------------------------------


def test_same_seed_same_schedule():
    s1 = cooldown_schedule(11, A, 6)
    assert s1 == cooldown_schedule(11, A, 6) and len(s1) == 6
    assert cooldown_schedule(11, A, 4) != cooldown_schedule(12, A, 4)
    assert cooldown_schedule(11, A, 4) != cooldown_schedule(11, B, 4)
    assert cooldown_schedule(3, A, 0) == []


def test_exponential_caps_with_bounded_jitter():
    base, cap = 0.25, 8.0
    for n, v in enumerate(cooldown_schedule(3, A, 8, base_s=base,
                                            max_s=cap)):
        hi = min(cap, base * 2.0 ** n)
        assert hi * 0.5 <= v < hi


def test_threshold_failures_open_the_circuit():
    h = _cache()
    for _ in range(2):
        h.record_failure(A, now=10.0)
    assert not h.snapshot(now=10.0)["endpoints"][KEY_A]["open"]
    h.record_failure(A, now=10.0)
    snap = h.snapshot(now=10.0)["endpoints"][KEY_A]
    assert snap["open"] and snap["openings"] == 1
    assert h.order(now=10.0)[-1] == A


def test_cooldown_is_the_seeded_schedule():
    h = _cache(seed=21)
    for _ in range(3):
        h.record_failure(A, now=100.0)
    want = cooldown_schedule(21, A, 1)[0]
    assert h.snapshot(now=100.0 + want - 1e-6)["endpoints"][KEY_A]["open"]
    assert not h.snapshot(now=100.0 + want + 1e-6)["endpoints"][KEY_A][
        "open"]


def test_half_open_probe_then_recovery():
    h = _cache(failure_threshold=1)
    h.record_failure(A, now=0.0)
    elapsed = cooldown_schedule(7, A, 1)[0] + 0.01
    assert h.order(now=elapsed)[-1] == A
    h.record_success(A, 0.01, now=elapsed)
    snap = h.snapshot(now=elapsed)["endpoints"][KEY_A]
    assert not snap["open"] and snap["openings"] == 0


def test_consecutive_openings_back_off_exponentially():
    h = _cache(seed=5, failure_threshold=1)
    h.record_failure(A, now=0.0)
    first, second = cooldown_schedule(5, A, 2)
    h.record_failure(A, now=first + 1.0)
    snap = h.snapshot(now=first + 1.0 + second - 1e-6)["endpoints"][KEY_A]
    assert snap["open"] and snap["openings"] == 2


def test_success_resets_consecutive_failures():
    h = _cache(failure_threshold=3)
    h.record_failure(A, now=0.0)
    h.record_failure(A, now=0.0)
    h.record_success(A, 0.01, now=0.0)
    h.record_failure(A, now=0.0)
    assert not h.snapshot(now=0.0)["endpoints"][KEY_A]["open"]


def test_all_open_still_returns_everything():
    h = _cache(failure_threshold=1)
    for ep in (A, B, C):
        h.record_failure(ep, now=0.0)
    assert sorted(h.order(now=0.0)) == sorted([A, B, C])


def test_primary_belief_orders_writes_only():
    h = _cache()
    h.set_primary(B)
    assert h.order(write=True, now=0.0)[0] == B
    assert h.believed_primary() == B
    assert h.order(write=False, now=0.0)[0] == A
    h.record_failure(B, now=0.0)
    assert h.believed_primary() is None


def test_redirect_clears_belief_and_memoizes_for_writes():
    h = _cache(redirect_memo_s=1.0, failure_threshold=1)
    h.set_primary(A)
    h.record_redirect(A, now=0.0)
    assert h.believed_primary() is None
    assert h.order(write=True, now=0.5)[0] != A
    assert h.order(write=False, now=0.5)[0] == A
    assert h.order(write=True, now=1.5)[0] == A
    snap = h.snapshot(now=0.0)["endpoints"][KEY_A]
    assert not snap["open"] and snap["failures"] == 0


def test_latency_tiebreak():
    h = _cache()
    h.record_success(A, 0.5, now=0.0)
    h.record_success(B, 0.05, now=0.0)
    h.record_success(C, 0.2, now=0.0)
    assert h.order(now=0.0) == [B, C, A]
    h = _cache(ewma_alpha=0.5)
    h.record_success(A, 0.4, now=0.0)
    h.record_success(A, 0.2, now=0.0)
    assert h.snapshot(now=0.0)["endpoints"][KEY_A]["ewma_s"] == \
        pytest.approx(0.3)
    h = _cache()
    # 1 ms apart rounds to the same 10 ms bucket: index breaks the tie
    h.record_success(B, 0.101, now=0.0)
    h.record_success(A, 0.102, now=0.0)
    assert h.order(now=0.0)[0] == A


def test_snapshot_is_json_safe_and_unknown_endpoints_are_ignored():
    h = _cache()
    h.record_success(A, 0.25, now=0.0)
    h.record_failure(B, now=0.0)
    h.set_primary(A)
    snap = h.snapshot(now=0.0)
    assert json.loads(json.dumps(snap)) == snap
    assert snap["primary"] == list(A)
    h.record_success(("10.0.0.9", 1), 0.1, now=0.0)
    h.record_failure(("10.0.0.9", 1), now=0.0)
    assert sorted(h.order(now=0.0)) == sorted([A, B, C])
    with pytest.raises(ValueError):
        EndpointHealthCache([])
