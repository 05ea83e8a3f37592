"""Starts the port's ``cli serve`` with the arguments given:

    python3 portbench/drivers/serve_launch.py serve --store ... --frontends 4 ...

The service spawns its front ends and its dispatcher, and a spawned
process imports its parent's main module, this file, before it runs. So
the part of this file outside ``__main__`` runs in every process of the
service. It does one thing, and only where ``PORTBENCH_FAULT=answer`` is
set, which only the fault tests do: the dispatcher alters the first
prediction of every answer it produces, so that such a run comes out
not correct. Nothing of the port's files is touched.
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

FAULT_ENV = "PORTBENCH_FAULT"


def _alter_answers() -> None:
    from bodywork_tpu_torch.serve.dispatch import DispatchServer

    predict = DispatchServer._predict

    def altered(self, served, X):
        predictions = predict(self, served, X).copy()
        predictions.reshape(-1)[0] += 1.0
        return predictions

    DispatchServer._predict = altered


if os.environ.get(FAULT_ENV) == "answer":
    _alter_answers()

if __name__ == "__main__":
    from bodywork_tpu_torch.cli import main

    sys.exit(main(sys.argv[1:]))
