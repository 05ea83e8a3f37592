#!/usr/bin/env python3
"""Whether a profiled run keeps every graph-replayed kernel in its trace.

Run on a machine with a CUDA card, from the repository root::

    python3 tools/profile_repeat.py [--reps 8] [--variants repo,plain]

Repeats ``chip_smoke.py``'s ``profile`` run (``cli run-sim --profile-dir``
of the 1024-wide MLP for 2 days at ``PROFILE_SIM``'s steps) in one
process, after one unprofiled run that captures the serving graphs and
one tiny profiler session (a later session is what lost records: the
first profile of a process keeps them). ``--variants`` takes turns
between ``utils.profiling.maybe_trace`` as the repository has it
(``repo``) and a profile closed right after the region's synchronize
(``plain``). One JSON line per run: the f32 launches the wrapper counted,
the trace's ``cudaGraphLaunch`` events, the f32 kernels it names, and for
each graph launch whose kernel it names, where the launch lies in the
trace (ms from its first event) and how far the kernel's timestamp lies
from its launch's (``skew_us``: on the card the two are within 0.1 ms
in a process's first profile); ``lost`` the launches it does not name,
``window_margin_ms`` the trace's extent past the last launch.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def _plain_trace(trace_dir, label="", device=None):
    """The profile block closed right after the region's synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bodywork_tpu_torch.utils.profiling import trace_path

    if not trace_dir:
        yield None
        return
    path = trace_path(trace_dir, label)
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        try:
            yield prof
        finally:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


def _read(path: str) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("name") == "cudaGraphLaunch" and "correlation" in (e.get("args") or {})}
    named = {(e.get("args") or {}).get("correlation"): e["ts"] for e in events
             if e.get("cat") == "kernel" and "mlp_f32_kernel" in e.get("name", "")}
    timed = [e for e in events if isinstance(e.get("ts"), (int, float))]
    first = min(e["ts"] for e in timed)
    end = max(e["ts"] + e.get("dur", 0) for e in timed)
    return {
        "graph_launches": len(launches),
        "f32_kernel_named": len(named),
        "skew_us": [[round((launches[c] - first) / 1e3, 1), round(named[c] - launches[c], 1)]
                    for c in sorted(launches) if c in named],
        "lost": [round((launches[c] - first) / 1e3, 1) for c in sorted(launches)
                 if c not in named],
        "window_margin_ms": round((end - max(launches.values())) / 1e3, 1)
        if launches else None,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=8)
    parser.add_argument("--variants", default="repo,plain")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_repeat: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from bodywork_tpu_torch import cli
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.utils import profiling
    from bodywork_tpu_torch.utils.logging import configure_logger

    configure_logger("WARNING", stream=sys.stderr)
    dev = torch.device("cuda")
    cs.phase_device(torch)
    cs.phase_build()
    repo_trace = profiling.maybe_trace
    work = tempfile.mkdtemp(dir=cs._scratch_dir())

    def run_sim(name: str, profiled: bool) -> dict:
        prof_dir = os.path.join(work, name, "profile")
        argv = ["--log-level", "WARNING", "run-sim", "--store", os.path.join(work, name, "s"),
                "--days", str(cs.PROFILE_SIM["days"]), "--date", str(cs.LOOP_START),
                "--model", "mlp", "--mlp-hidden", ",".join(map(str, cs.HIDDEN)),
                "--mlp-steps", str(cs.PROFILE_SIM["n_steps"]),
                "--mlp-lr", str(cs.LOOP_MLP["learning_rate"]), "--device", "cuda"]
        if profiled:
            argv += ["--profile-dir", prof_dir]
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv)
        out = {"rc": rc, "seconds": round(time.perf_counter() - t0, 3),
               "launches": LAUNCHES["kernel"]}
        if profiled:
            out.update(_read(str(profiling.trace_path(
                prof_dir, f"{cs.PROFILE_SIM['days']}-day simulation"))))
        return out

    run_sim("capture", profiled=False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (torch.ones(64, 64, device=dev) @ torch.ones(64, 64, device=dev)).sum().item()
    for rep in range(args.reps):
        for variant in args.variants.split(","):
            profiling.maybe_trace = repo_trace if variant == "repo" else _plain_trace
            try:
                out = run_sim(f"{variant}-{rep}", profiled=True)
            finally:
                profiling.maybe_trace = repo_trace
            out.update(rep=rep, variant=variant,
                       ok=out["rc"] == 0 and out["f32_kernel_named"] == out["launches"])
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
