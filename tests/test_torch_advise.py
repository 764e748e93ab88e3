"""The serving layer's own copy of the budget advisor
(``serving._advise``) against the repository's tool
(``tools/advise_budget.py``'s ``advise`` and ``tools/inspect_journal.py``'s
``load_manifest``): on the same manifests — single-lane, pipelined,
backed-off, host-resident, telemetry-bearing, sharded and elastic, and a
server's batch journals — both give the same advice, key for key.  The
package never loads the tool; this test does, to hold the copy to it.
"""

import importlib.util
import gc
import json
import os
import sys

import numpy as np
import pytest
import torch

from spark_timeseries_tpu_torch import obs
from spark_timeseries_tpu_torch import reliability as rel
from spark_timeseries_tpu_torch.parallel import mesh as meshlib
from spark_timeseries_tpu_torch.reliability import faultinject as fi
from spark_timeseries_tpu_torch.reliability.journal import TornManifestError
from spark_timeseries_tpu_torch.serving import _advise
from test_torch_chunked import _tfake

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


@pytest.fixture(autouse=True)
def _no_pool_outlives_its_test():
    """A staging pool registers with the process-wide peak-memory probe
    while it lives; one left in cyclic garbage would show in the next
    test's journal entries (``peak_staging_pool_bytes``)."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def tool():
    sys.path.insert(0, TOOLS)
    try:
        spec = importlib.util.spec_from_file_location(
            "_advise_budget_tool", os.path.join(TOOLS, "advise_budget.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        import inspect_journal
    finally:
        sys.path.remove(TOOLS)
    return mod, inspect_journal


def _panel(b=48, t=8):
    return np.random.default_rng(2).normal(size=(b, t)).astype(np.float32)


def _walk(d, **kw):
    kw.setdefault("chunk_rows", 8)
    y = kw.pop("y", torch.as_tensor(_panel()))
    fit = kw.pop("fit", _tfake)
    return rel.fit_chunked(fit, y, resilient=False, device="cpu",
                           checkpoint_dir=str(d), **kw)


CASES = {
    "serial": dict(pipeline=False),
    "pipelined": dict(),
    "backoff": dict(fit=fi.oom_fit(_tfake, 5), min_chunk_rows=2),
    "timeouts": dict(fit=fi.hanging_fit(_tfake, [1], sleep_s=0.6),
                     chunk_budget_s=0.2),
    # a host source is built inside the test: a live staging pool
    # registers with the process-wide peak-memory probe, and one made at
    # import would show in every later manifest of the process
    "host": dict(y="host"),
    "sharded": dict(mesh=meshlib.default_mesh(
        devices=[torch.device("cpu")] * 3)),
    "elastic": dict(fit=fi.lane_kill(_tfake, 1, after_chunks=1),
                    mesh=meshlib.default_mesh(
                        devices=[torch.device("cpu")] * 3),
                    lane_retry_backoff_s=0.01),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("telemetry", [False, True])
def test_advice_matches_the_tool(tool, case, telemetry, tmp_path):
    mod, ij = tool
    d = tmp_path / "j"
    if telemetry:
        obs.enable(str(tmp_path / "ev.jsonl"))
    kw = dict(CASES[case])
    if kw.get("y") == "host":
        kw["y"] = rel.HostChunkSource(_panel())
    try:
        _walk(d, **kw)
    finally:
        if telemetry:
            obs.disable()
    m = _advise.load_manifest(str(d))
    assert m == ij.load_manifest(str(d))
    got, want = _advise.advise(m), mod.advise(m)
    assert json.dumps(got, sort_keys=True, default=repr) == \
        json.dumps(want, sort_keys=True, default=repr)


def test_server_batch_manifests_match_the_tool(tool, tmp_path):
    from spark_timeseries_tpu_torch import serving

    mod, _ = tool
    y = _panel(16, 40)
    with serving.FitServer(str(tmp_path / "srv"), cell_rows=8,
                           autotune=True, device="cpu") as srv:
        for i in range(2):
            srv.submit(f"t{i}", y, "arima", order=(1, 0, 0),
                       max_iters=10).result(timeout=300)
    batches = os.path.join(srv.root, "batches")
    seen = 0
    for bid in sorted(os.listdir(batches)):
        m = _advise.load_manifest(os.path.join(batches, bid, "journal"))
        assert json.dumps(_advise.advise(m), sort_keys=True) == \
            json.dumps(mod.advise(m), sort_keys=True)
        seen += 1
    assert seen == 2


def test_load_manifest_absent_and_torn(tmp_path):
    assert _advise.load_manifest(str(tmp_path)) is None
    (tmp_path / "manifest.json").write_text("{not json")
    with pytest.raises(TornManifestError):
        _advise.load_manifest(str(tmp_path))
