"""The port's chaos library (``reliability.chaos``) against the
reference's (``tests/test_chaos.py``): the seeded scenario generator, the
schedule runner, the unavailability windows, the invariant checker, the
injection join and the durable scenario record.

The library is host code, so the bar is equality: the same seed gives the
same events, the same evidence the same violations and windows, the same
manifest the same bytes on disk.  Results in the invariants may hold
tensors (a port result read on the card) or host arrays alike.
"""

import json

import numpy as np
import pytest
import torch

from spark_timeseries_tpu.reliability import chaos as rchaos
from spark_timeseries_tpu_torch.reliability import chaos
from spark_timeseries_tpu_torch.reliability.chaos import (
    ChaosEvent, ChaosRunner, chaos_schedule, check_invariants,
    unavailability_windows)


class _Res:
    def __init__(self, params, nll=None):
        self.params = np.asarray(params)
        self.neg_log_likelihood = (np.zeros(len(self.params), np.float32)
                                   if nll is None else np.asarray(nll))
        self.converged = np.ones(len(self.params), bool)
        self.iters = np.full(len(self.params), 7, np.int32)
        self.status = np.zeros(len(self.params), np.int8)


# -- equality with the reference ----------------------------------------------

KINDS = [("kill", "disk", "frames"), ("kill", "pause"),
         ("kill", "disk", "frames", "pause")]


@pytest.mark.parametrize("seed", [0, 5, 23, 2 ** 31 - 1])
@pytest.mark.parametrize("kinds", KINDS, ids=["default", "kp", "all"])
def test_schedule_equals_the_reference(seed, kinds):
    for dur, n in ((2.0, 4), (6.0, 24), (0.05, 3)):
        got = chaos_schedule(seed, dur, n_events=n, kinds=kinds,
                             targets=("primary", "standby", "r2"))
        want = rchaos.chaos_schedule(seed, dur, n_events=n, kinds=kinds,
                                     targets=("primary", "standby", "r2"))
        assert [tuple(e) for e in got] == [tuple(e) for e in want]


def _probes(seed):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.0, 0.5, size=40))
    return [(float(x), bool(ok)) for x, ok in zip(t, rng.random(40) < 0.6)]


@pytest.mark.parametrize("seed", range(4))
def test_windows_and_invariants_equal_the_reference(seed):
    probes = _probes(seed)
    assert unavailability_windows(probes) == \
        rchaos.unavailability_windows(probes)
    rng = np.random.default_rng(100 + seed)
    ids = [f"r{i}" for i in range(6)]
    answers = {i: (None if rng.random() < 0.2 else
                   _Res(rng.normal(size=(3, 2)).astype(np.float32)))
               for i in ids}
    answers["ghost"] = _Res([[1.0]])
    reanswers = {i: (r if rng.random() < 0.5 or r is None else
                     _Res(r.params + np.float32(1e-3)))
                 for i, r in answers.items()}
    owners = ["a", "b", "c"]
    history = [{"token": int(rng.integers(1, 4)),
                "owner": owners[int(rng.integers(0, 3))]}
               for _ in range(8)]
    kw = dict(expected_ids=ids, answers=answers, reanswers=reanswers,
              lease_history=history, probes=probes, max_unavailable_s=0.6)
    got = check_invariants(**kw)
    want = rchaos.check_invariants(**kw)
    assert [tuple(v) for v in got] == [tuple(v) for v in want]
    assert got, "the evidence was built to hold violations"


def test_tensor_results_are_judged_as_their_host_arrays():
    a = _Res([[1.0, 2.0]])
    t = _Res([[1.0, 2.0]])
    t.params = torch.tensor([[1.0, 2.0]])
    t.neg_log_likelihood = torch.zeros(1)
    assert check_invariants(answers={"a": a}, reanswers={"a": t}) == []
    t.params = torch.tensor([[1.0, 2.5]])
    assert [v.invariant for v in check_invariants(
        answers={"a": a}, reanswers={"a": t})] == ["bitwise"]


def test_join_injections_equals_the_reference():
    fired = [{"kind": "pause", "t_s": 0.2}, {"kind": "kill", "t_s": 1.0},
             {"kind": "kill", "t_s": 3.0}, {"kind": "kill", "t_s": 5.0}]
    events = [
        {"name": "fleet.elected", "ts": 10.0, "attrs": {"owner": "a",
                                                         "token": 1},
         "stream": "a"},
        {"name": "fleet.heartbeat", "ts": 11.5, "stream": "a"},
        {"name": "fleet.elected", "ts": 13.0, "owner": "b", "token": 2,
         "stream": "b"},
        {"name": "server.admit", "ts": 14.0, "stream": "b"},
        {"name": "fleet.elected", "ts": 16.25, "attrs": {"owner": "a",
                                                          "token": 3},
         "stream": "a"},
    ]
    got = chaos.join_injections(fired, events)
    assert got == rchaos.join_injections(fired, events)
    assert [r["observed"] for r in got] == [True, True, False]
    assert got[0]["victim"] == "a" and got[0]["takeover_latency_s"] == 1.5


def test_manifest_bytes_equal_the_reference(tmp_path):
    manifest = {"kind": "chaos_soak", "seed": 23,
                "schedule": [e._asdict() for e in chaos_schedule(23, 2.0)],
                "probes": _probes(1)[:5], "violations": [],
                "token": np.int64(3)}  # a numpy scalar goes through repr
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    path = chaos.write_chaos_manifest(str(tmp_path / "p"), manifest)
    rpath = rchaos.write_chaos_manifest(str(tmp_path / "r"), manifest)
    assert open(path, "rb").read() == open(rpath, "rb").read()
    assert chaos.load_chaos_manifest(str(tmp_path / "r")) == \
        rchaos.load_chaos_manifest(str(tmp_path / "p"))


# -- the reference's cases on the port ----------------------------------------


def test_same_seed_same_scenario_sorted_inside_window():
    assert chaos_schedule(23, 5.0) == chaos_schedule(23, 5.0)
    assert chaos_schedule(23, 5.0) != chaos_schedule(24, 5.0)
    sched = chaos_schedule(3, 4.0, n_events=8)
    ts = [e.t_s for e in sched]
    assert ts == sorted(ts) and all(0.1 <= t <= 4.0 for t in ts)
    assert len(sched) == 8


def test_kinds_targets_and_params():
    sched = chaos_schedule(7, 3.0, n_events=16, kinds=("kill", "pause"),
                           targets=("primary",))
    assert {e.kind for e in sched} <= {"kill", "pause"}
    assert {e.target for e in sched} == {"primary"}
    for e in chaos_schedule(11, 6.0, n_events=24,
                            kinds=("kill", "disk", "frames", "pause")):
        if e.kind == "kill":
            assert 1 <= e.params["after_commits"] <= 3
        elif e.kind == "disk":
            assert 0.05 <= e.params["eio_frac"] <= 0.2
            assert e.params["n"] == 32
        elif e.kind == "frames":
            assert 0.02 <= e.params["drop_frac"] <= 0.1
        else:
            assert 0.1 <= e.params["pause_s"] <= 0.5
    sched = chaos_schedule(5, 2.0)
    rt = json.loads(json.dumps([e._asdict() for e in sched]))
    assert [ChaosEvent(**d) for d in rt] == sched
    with pytest.raises(ValueError):
        chaos_schedule(1, 2.0, kinds=("meteor",))
    with pytest.raises(ValueError):
        chaos_schedule(1, 2.0, targets=())


def test_runner_fires_in_time_order_and_records_errors():
    hits = []

    def boom(e):
        raise RuntimeError("victim already dead")

    sched = [ChaosEvent(0.03, "pause", "b", {}),
             ChaosEvent(0.01, "pause", "a", {}),
             ChaosEvent(0.02, "kill", "primary", {"after_commits": 1})]
    runner = ChaosRunner(sched, {"pause": lambda e: hits.append(e.target),
                                 "kill": boom})
    fired, errors = runner.start().join(timeout_s=30)
    assert hits == ["a", "b"]
    assert [f["kind"] for f in fired] == ["pause", "pause"]
    assert all(f["fired_at_s"] >= f["t_s"] for f in fired)
    assert len(errors) == 1 and "victim already dead" in errors[0]["error"]
    with pytest.raises(ValueError, match="kill"):
        ChaosRunner([ChaosEvent(0.1, "kill", "primary", {})],
                    {"pause": lambda e: None})
    with pytest.raises(RuntimeError):
        runner.start()


def test_stop_cancels_pending_events():
    hits = []
    runner = ChaosRunner([ChaosEvent(30.0, "pause", "primary", {})],
                         {"pause": lambda e: hits.append(e)}).start()
    runner.stop()
    fired, errors = runner.join(timeout_s=30)
    assert fired == [] and errors == [] and hits == []


@pytest.mark.parametrize("probes,want", [
    ([], []),
    ([(0.0, True), (1.0, True)], []),
    ([(0.0, True), (1.0, False), (2.0, False), (3.0, True)], [(1.0, 3.0)]),
    ([(0.0, True), (1.0, False), (2.5, False)], [(1.0, 2.5)]),
    ([(0.0, True), (1.0, False)], [(1.0, 1.0)]),
    ([(0.0, False), (1.0, True), (2.0, False), (3.0, True)],
     [(0.0, 1.0), (2.0, 3.0)]),
])
def test_unavailability_windows(probes, want):
    assert unavailability_windows(probes) == want


def test_check_invariants_cases():
    r = _Res([[1.0, 2.0]])
    assert check_invariants(
        expected_ids=["a"], answers={"a": r}, reanswers={"a": r},
        lease_history=[{"token": 1, "owner": "p"},
                       {"token": 1, "owner": "p"},
                       {"token": 2, "owner": "s"}],
        probes=[(0.0, True), (1.0, False), (1.4, True)],
        max_unavailable_s=1.0) == []

    def kinds(**kw):
        return [v.invariant for v in check_invariants(**kw)]

    assert kinds(expected_ids=["a", "b"],
                 answers={"a": _Res([[1.0]]), "b": None}) == ["conservation"]
    assert kinds(expected_ids=["a"], answers={
        "a": _Res([[1.0]]), "ghost": _Res([[2.0]])}) == ["conservation"]
    assert kinds(answers={"a": _Res([[1.0, 2.0]])},
                 reanswers={"a": _Res([[1.0, 2.000001]])}) == ["bitwise"]
    assert kinds(answers={"a": _Res([[np.nan]], nll=[np.nan])},
                 reanswers={"a": _Res([[np.nan]], nll=[np.nan])}) == []
    assert kinds(lease_history=[{"token": 3, "owner": "a"},
                                {"token": 2, "owner": "b"}]) == ["fencing"]
    assert kinds(lease_history=[{"token": 2, "owner": "a"},
                                {"token": 2, "owner": "b"}]) == ["fencing"]
    assert kinds(probes=[(0.0, True), (1.0, False), (5.0, True)],
                 max_unavailable_s=2.0) == ["availability"]
    assert check_invariants() == []


def test_manifest_round_trip_is_atomic(tmp_path):
    manifest = {"kind": "chaos_soak", "seed": 23,
                "schedule": [e._asdict() for e in chaos_schedule(23, 2.0)],
                "violations": []}
    path = chaos.write_chaos_manifest(str(tmp_path), manifest)
    assert path.endswith(chaos.CHAOS_MANIFEST)
    assert chaos.load_chaos_manifest(str(tmp_path)) == manifest
    assert [p.name for p in tmp_path.iterdir()] == [chaos.CHAOS_MANIFEST]
