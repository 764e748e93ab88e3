"""The multi-process walk: two processes in one ``torch.distributed``
group on gloo (the port's ``parallel.mesh.init_distributed``), each
running the lanes of its own cells, held to the single-process walk bit
for bit — the analog of the reference's two-process ``jax.distributed``
fit (``tests/test_parallel.py::test_two_process_distributed_fit``).

Each process lists the CPU device twice, so the global mesh has four
cells (two a process); each contributes its half of the rows through
``distribute_panel``, walks ARIMA(1,0,0) chunks on its two lanes, and
journals into the shared checkpoint root; process 0 merges the manifest
after the barrier.  The worker is this file:
``python tests/test_torch_distributed.py worker RANK NPROC HOST:PORT DIR``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

ROWS, T, CHUNK = 32, 48, 8
KW = dict(order=(1, 0, 0), max_iters=15, resilient=False)


def _panel():
    rng = np.random.default_rng(0)
    e = rng.normal(size=(ROWS, T)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, T):
        y[:, i] = 0.6 * y[:, i - 1] + e[:, i]
    y[5, :4] = np.nan  # a ragged row: the group must agree on the plan
    return y


def _worker(rank, nproc, coord, out):
    import torch

    from spark_timeseries_tpu_torch import reliability as rel
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.init_distributed(coord, num_processes=nproc,
                                    process_id=rank,
                                    devices=[torch.device("cpu")] * 2)
    assert torch.distributed.get_backend() == "gloo"
    assert meshlib.cell_processes(mesh) == [0, 0, 1, 1]
    y = _panel()
    half = ROWS // nproc
    local = torch.as_tensor(y[rank * half:(rank + 1) * half])
    dp = meshlib.distribute_panel(local, mesh)
    assert dp.shape == (ROWS, T)
    assert [b[:2] for b in dp.blocks] == [
        (rank * half + k * half // 2, rank * half + (k + 1) * half // 2)
        for k in range(2)]
    res = rel.fit_chunked(arima.fit, dp, mesh=mesh, chunk_rows=CHUNK,
                          device="cpu", checkpoint_dir=os.path.join(out, "j"),
                          **KW)
    np.savez(os.path.join(out, f"rank{rank}.npz"), params=res.params,
             nll=res.neg_log_likelihood, converged=res.converged,
             iters=res.iters, status=res.status)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"shards": res.meta["shards"],
                   "journal": res.meta["journal"],
                   "align_mode": res.meta.get("align_mode")}, f)
    torch.distributed.destroy_process_group()


def test_two_process_gloo_walk_is_the_single_process_walk(tmp_path):
    import torch

    from spark_timeseries_tpu_torch import reliability as rel
    from spark_timeseries_tpu_torch.models import arima

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), "2",
         coord, str(tmp_path)], env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"stdout:\n{so}\nstderr:\n{se}"

    want = rel.fit_chunked(arima.fit, torch.as_tensor(_panel()),
                           chunk_rows=CHUNK, device="cpu", **KW)
    parts = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for f, attr in (("params", "params"), ("nll", "neg_log_likelihood"),
                    ("converged", "converged"), ("iters", "iters"),
                    ("status", "status")):
        np.testing.assert_array_equal(
            np.concatenate([p[f] for p in parts]),
            np.asarray(getattr(want, attr)), err_msg=f)
    metas = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert metas[0]["shards"]["lanes_run"] == 2
    assert metas[1]["shards"]["lanes_run"] == 2
    assert metas[0]["shards"]["n_shards"] == 4
    assert metas[0]["align_mode"] == metas[1]["align_mode"] == \
        want.meta["align_mode"]
    assert metas[0]["journal"]["merged_shards"] == 4
    assert metas[1]["journal"]["manifest"] is None  # process 0 merges
    m = json.load(open(tmp_path / "j" / "manifest.json"))
    assert m["merged_from_shards"] == 4
    assert [c["lo"] for c in m["chunks"]] == list(range(0, ROWS, CHUNK))
    assert all(c["status"] == "committed" for c in m["chunks"])


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
