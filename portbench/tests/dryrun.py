"""A whole run of one cell on the CPU at a small size, the harness's look
for a card skipped, optionally with the timed path broken underneath:

    python3 portbench/tests/dryrun.py <cell> <trace 0|1> [fault]

Faults: ``unchanged`` (training: the Adam step returns the weights
unchanged), ``late_count`` (training: from step 4 on, Adam's bias
correction takes the step count as 1, a fault the first three steps
cannot show), ``half_batch`` (training: each step's loss over the first
half of its minibatch alone), ``answer`` (serving: the dispatcher alters
the first prediction of each answer). Exits with the harness's code; the
result line is the last line of standard output.
"""
import os
import sys
import time

START = time.monotonic()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench.harness import clean_environment, run_cell, spec  # noqa: E402

#: each driver's small shapes for the CPU
SMALL = {
    "serve_closed_loop": ({"hidden": [32, 32, 32]},
                          {"shards": 1, "connections": 2, "frontends": 1, "pool": 4,
                           "warmup": 2, "rows": 100}),
    "train_fits": ({"hidden": [32, 32, 32], "batch_size": 256, "n_steps": 40},
                   {"rows": 2048}),
}
SECONDS = 1.5


def plant(fault: str) -> None:
    if fault == "answer":
        os.environ["PORTBENCH_FAULT"] = "answer"
        return
    from bodywork_tpu_torch.models import mlp

    if fault == "unchanged":
        mlp._adam_update = lambda *args, **kwargs: None
    elif fault == "late_count":
        update = mlp._adam_update

        def late(params, grads, mu, nu, count, lr):
            update(params, grads, mu, nu, count if count <= 3 else 1, lr)

        mlp._adam_update = late
    elif fault == "half_batch":
        loss = mlp._loss

        def half(net, xb, yb, wb, compute_dtype=None):
            n = xb.shape[0] // 2
            return loss(net, xb[:n], yb[:n], wb[:n], compute_dtype)

        mlp._loss = half
    else:
        raise SystemExit(f"unknown fault {fault!r}")


def main(argv) -> int:
    clean_environment()
    cell, trace = argv[0], int(argv[1])
    if len(argv) > 2:
        plant(argv[2])
    bench = spec.with_parked(spec.load_benchmark())
    driver = spec.traffic(spec.cell(bench, cell)["traffic"])["driver"]
    config_overrides, traffic_overrides = SMALL[driver]
    code, _result = run_cell(bench, cell, 2**31 + 1234567, SECONDS, trace, START,
                             device="cpu", config_overrides=config_overrides,
                             traffic_overrides=traffic_overrides)
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
