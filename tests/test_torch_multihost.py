"""The port's multi-process path run, as ``tests/test_multihost.py`` runs
the JAX package's: two OS processes join a gloo group through
``multihost_init`` (the emitted Indexed-Job pods' entry point), build one
2x1 mesh whose data axis spans both, and run the sharded fit, the
gradients all-reduced across the process boundary. Both processes must
hold the same model, and it must equal a one-process 2x1 fit of the
same data and seed."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env(port: int, proc_id: int, n_proc: int) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "JOB_COMPLETION_INDEX",
                        "BODYWORK_TPU_VIRTUAL_DEVICES")}
    env.update({
        "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "NUM_PROCESSES": str(n_proc),
        "PROCESS_ID": str(proc_id),
        "PYTHONPATH": str(ROOT),
    })
    return env


def test_two_process_group_runs_the_sharded_fit(tmp_path):
    port = _free_port()
    worker = Path(__file__).parent / "_torch_multihost_worker.py"
    outs = [tmp_path / f"worker_{i}.json" for i in range(2)]
    procs = [subprocess.Popen([sys.executable, str(worker), str(outs[i])],
                              env=_worker_env(port, i, 2), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for i in range(2)]
    for p in procs:
        try:
            _stdout, stderr = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out (the group never formed?)")
        assert p.returncode == 0, stderr.decode(errors="replace")[-1500:]
    facts = [json.loads(o.read_text()) for o in outs]
    assert sorted((f["rank"], f["world"], f["data_offset"]) for f in facts) == [
        (0, 2, 0), (1, 2, 1)]
    p0, p1 = (np.asarray(f["predictions"]) for f in facts)
    np.testing.assert_array_equal(p0, p1)
    assert facts[0]["final_loss"] == facts[1]["final_loss"]

    from bodywork_tpu_torch.models.mlp import MLPConfig
    from bodywork_tpu_torch.parallel import make_mesh, train_mlp_sharded

    torch.set_num_threads(1)
    rng = np.random.default_rng(5)
    n = 1024
    X = rng.uniform(0, 100, n).astype(np.float32)
    y = (1.0 + 0.5 * X + rng.normal(0, 1, n)).astype(np.float32)
    cfg = MLPConfig(hidden=(16, 16), n_steps=120, batch_size=128, learning_rate=1e-2)
    model = train_mlp_sharded(X, y, cfg, make_mesh(2, 1, [torch.device("cpu")] * 2), seed=7)
    Xq = np.linspace(0.0, 100.0, 32, dtype=np.float32)[:, None]
    # the JAX test's bar for the two-process run against one process
    np.testing.assert_allclose(p0, model.predict(Xq), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(facts[0]["final_loss"], model.final_loss, rtol=1e-4)
