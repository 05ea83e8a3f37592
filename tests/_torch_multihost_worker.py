"""Worker process of the port's two-process gloo group test
(underscore-prefixed: a helper pytest must not collect).

Each worker joins the group through the entry point the emitted
Indexed-Job pods use (``parallel.multihost_init``, keyed on the
coordinator and topology env), builds a 2x1 mesh whose data axis spans
both processes, runs the sharded fit and writes its predictions, its
final loss and the group's facts to its output file.

Usage: python _torch_multihost_worker.py <out_file>
"""
import json
import sys


def main() -> int:
    out_file = sys.argv[1]

    import numpy as np
    import torch

    from bodywork_tpu_torch.models.mlp import MLPConfig
    from bodywork_tpu_torch.parallel import (
        make_mesh,
        multihost_init,
        multihost_shutdown,
        train_mlp_sharded,
    )
    from bodywork_tpu_torch.parallel.mesh import process_layout

    torch.set_num_threads(1)
    assert multihost_init("cpu"), "coordinator env not detected"
    assert multihost_init("cpu"), "a second multihost_init must be a no-op"
    try:
        rank, world = process_layout()
        rng = np.random.default_rng(5)
        n = 1024
        X = rng.uniform(0, 100, n).astype(np.float32)
        y = (1.0 + 0.5 * X + rng.normal(0, 1, n)).astype(np.float32)
        cfg = MLPConfig(hidden=(16, 16), n_steps=120, batch_size=128, learning_rate=1e-2)
        mesh = make_mesh(data=2, model=1, devices=[torch.device("cpu")])
        model = train_mlp_sharded(X, y, cfg, mesh, seed=7)
        Xq = np.linspace(0.0, 100.0, 32, dtype=np.float32)[:, None]
        facts = {"rank": rank, "world": world, "data_offset": mesh.data_offset,
                 "final_loss": model.final_loss,
                 "predictions": [float(p) for p in model.predict(Xq)]}
    finally:
        assert multihost_shutdown(), "shutdown should report it left the group"
    with open(out_file, "w") as f:
        json.dump(facts, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
