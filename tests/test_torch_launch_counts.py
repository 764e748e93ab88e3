"""The kernel launch counters count exactly when several threads launch at
once: the multi-lane chunk walk's lanes launch from their own threads, and
``chip_smoke.py`` holds each walk's counts against the single-lane walk's.

No kernel runs here: the library load, the device context and the stream
are stood in for, so ``_launch`` and its counters run as on the card.  The
plain versions count nothing (a CPU tensor never reaches ``_launch``), so
a walk over CPU tensors leaves every count at 0 whatever its lanes do.
"""

import contextlib
import sys
import threading

import pytest
import torch

from spark_timeseries_tpu_torch.ops import _build
from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

THREADS = 8
CALLS = 2000


class _Lib:
    def __getattr__(self, name):
        return lambda *args: 0  # every launch succeeds


class _Stream:
    cuda_stream = 0


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    ck.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    yield
    sys.setswitchinterval(old)
    ck.reset_launch_counts()


def _hammer(fn, calls=CALLS):
    start = threading.Barrier(THREADS)
    errors = []

    def work():
        start.wait()
        try:
            for _ in range(calls):
                fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


@pytest.mark.parametrize("counter", sorted(ck.LAUNCHES))
def test_concurrent_launches_count_exactly(fake_card, counter):
    _hammer(lambda: ck._launch("css", "fn", counter, "cuda"))
    assert ck.LAUNCHES[counter] == THREADS * CALLS
    assert sum(ck.LAUNCHES.values()) == THREADS * CALLS


@pytest.mark.parametrize("route", ck.CSS_ROUTES)
def test_concurrent_route_counts_are_exact(fake_card, route):
    _hammer(lambda: ck._launch("css", "fn", "css_fwd", "cuda", route=route))
    assert ck.LAUNCHES["css_fwd"] == THREADS * CALLS
    assert ck.ROUTE_LAUNCHES["css_fwd"][route] == THREADS * CALLS
    ck.reset_launch_counts()
    assert ck.ROUTE_LAUNCHES["css_fwd"][route] == 0
    assert not any(ck.LAUNCHES.values())


def test_plain_versions_count_nothing_across_threads():
    ck.reset_launch_counts()
    yt = torch.randn(50, 16)
    params = torch.zeros(16, 3)
    zb = torch.zeros(16)
    _hammer(lambda: ck.css_fwd(yt, params, zb, 1, 1, "sum"), calls=20)
    assert not any(ck.LAUNCHES.values())
