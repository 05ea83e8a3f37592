#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bodywork_tpu_torch``) on one NVIDIA H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. ``device``  — the card's name, compute capability (must be 9.0) and
   ``nvidia-smi`` name and power limit, under the bring-up watchdog
   (``utils/watchdog.py``: a card that hangs in these first CUDA calls
   ends the run with exit 3 and one line on stderr after
   ``BODYWORK_TPU_BACKEND_TIMEOUT_S``, default 120 s); then ``generator``: the drift
   generator's threefry draws for all 365 dates of 2026 on the card
   against the CPU (``X`` and the kept-row mask must be bit-equal; the
   ``eps`` and ``y`` gaps are printed in ulps) and the card's time for
   one day; then ``mlp-draws``: the seeded MLP fit's threefry draws (the
   2000-step minibatch index stream and the 1024-wide He init) on the
   card against the CPU, bit-equal, with the card's draw times;
2. ``build``   — compiles the CUDA kernels from the repository's sources
   with ``nvcc``, one process per source, all started together
   (``ops/_build.py``), and prints the seconds and the compiler's
   register/shared-memory report;
3. ``kernels`` — each fused-MLP kernel (``kernel``: ``mlp_kernel.cu``;
   ``kernel-bf16``: ``mlp_bf16_tc.cu``; ``kernel-int8``: ``mlp_int8.cu``)
   at the served model's widths (1 -> 1024 -> 1024 -> 1024 -> 1) on {1, 8,
   300, 4096} rows, held against its plain PyTorch version on the card,
   with each launch's shape (row tile, cluster size, ring stages, dynamic
   shared memory), and the readings of cheaper arithmetic (``controls``),
   which each bar must refuse; ``kernels-ragged`` runs a ragged 3 -> 1100
   -> 40 -> 1 stack the same way at every cluster size the card schedules
   and checks that a stack past each kernel's shared memory is refused;
4. ``slice``   — the serving main path at full width: three days of drift
   data generated on the card, a (1024, 1024, 1024) MLP checkpoint with
   seeded He-init weights, ``serve_latest_model(engine="auto")`` (which
   must pick the ``kernel`` engine on ``cuda``), single and batch requests
   over HTTP checked against the plain version, then the port's test stage
   over HTTP on the latest day; ``slice-bf16`` / ``slice-int8`` serve the
   same checkpoint through the other two kernels; ``slice-auto-wide``
   serves a (1344, 1344, 1344) MLP, which the f32 kernel cannot launch, on
   ``auto``, which must resolve to the ``torch`` engine with no launch;
   ``slice-nan`` serves a model whose output is NaN through ``kernel``,
   which must answer 500 over HTTP without the value. Kernel launch counts
   are set to 0 just before each path and read just after it; then
   ``serving``, the serving machinery on a checkpoint of the same model:
   ``serve-graph`` serves it on ``auto`` (-> ``kernel``), ``kernel-bf16``
   and ``kernel-int8``, each from a cold graph cache (``serve.predictor``):
   the CUDA-graph captures must equal the buckets at warm-up and stay 0
   over the requests, every bucket's replay must be bit-equal to the same
   predictor's eager kernel launch, and the served answers, which fill
   every bucket, within the engine's bar of the plain version, with the
   host ms of a dispatch eager against replayed;
   ``serve-graph-swap`` serves a second checkpoint of the same
   architecture beside the first (no capture, one rebind; each service
   answering with its own weights); ``serve-graph-overlap`` captures while
   another thread runs 800 Adam steps of the 1024-wide MLP (the losses
   bit-equal to an unshared run); ``serve-coalesce`` runs config 7's
   shape (300 sequential single rows, then 16 clients x 25) on the
   ``thread`` and ``aio`` front ends with the coalescer off and on (2 ms,
   64 rows): p50/p99, rows per dispatch, every answer byte-identical to the
   uncoalesced thread engine's; ``serve-admission`` bursts 64 simultaneous
   rows at ``aio`` with ``max_pending`` 8: 429s with ``Retry-After``, every
   200 the unshed answer, the ``/metrics`` shed count equal to the 429s;
   then ``trace``: request tracing on that model, served on ``auto``
   (-> ``kernel``) on both front ends, coalescer off and on, at trace
   fraction 1.0: single rows, one with an ingress ``traceparent`` (whose
   id must be kept), one 4096-row batch, then 16 clients x 25: every
   response's 32-hex ``X-Bodywork-Trace-Id`` in a header and in no body,
   every trace with the JAX package's spans (``parse``, ``device-dispatch``
   with ``aot_cache`` and ``bucket``, ``serialize``, and ``queue-wait``
   when coalesced, every coalesced member linked to the one shared
   dispatch span), ``/healthz`` exemplars that resolve to recorded traces,
   and the median span breakdown of the 16 clients' requests;
   ``trace-overhead``: config 7 on ``thread`` (coalescer off) at fractions
   0, 0.1, 1.0, 1.0, 0.1, 0; then ``traffic``: config 9's open-loop ramp
   on ``aio`` (coalescer 2 ms, 64 rows): a closed-loop capacity probe,
   one seeded Poisson log at 0.5x, 1x and 2x of it (capped at 2000
   requests/s, 3 s each), an MMPP log at 1x, and the 1x log replayed
   from its file in the binary row framing, whose answers must be
   byte-identical to the JSON ones; every 200 held against the plain
   version; offered and goodput rps, p50/p99 from the scheduled arrival,
   the shed fraction, the real factor and the service's admission
   counters printed, every drive sent by 4 spawned driver processes;
   ``reload``: config 11's live swap, an open-loop drive at 0.5x capacity
   sent by 4 driver processes (its send-lag p99 within 50 ms, or the
   driver fails the phase) across a ``CheckpointWatcher`` swap
   to a second checkpoint of the same architecture (no capture, at least
   one rebind, every answer's model key and value its own checkpoint's,
   p99 per answering checkpoint), then ``cli registry rollback`` must
   reach the running service within two polls; ``canary``: the canary
   chaos acceptance (``nan``, ``latency``, ``healthy``) on 1024-wide
   MLPs: abort, abort, promote, production byte-identical to its
   canary-free twin, each flight record opened by ``cli trace show``,
   the canary on the weight-slot lane beside production's with no rebind
   and no capture during a drive, the six slowest requests of each stream
   printed; ``tune``: config 13's shape, ``cli serve`` (``aio``, ``auto``
   -> ``kernel``, the defaults) driven by the ``uniform_row`` and
   ``heavy_tail_row`` profiles 4 s each with their request and results
   logs, ``cli tune --device cuda`` on them (the dispatch-cost probe on
   the card, the cost model within its held-out bound, ``tune status``,
   ``tuning/`` clean under fsck), then ``cli serve --tuned-config latest
   --cost-budget-s 4.0`` whose ``/healthz`` must report the document's
   knobs and digest, both profiles again, every answer held against the
   plain version, default against tuned printed; ``online-tune``: config
   18's shape in process, the online controller's refit applied and
   graduated with no capture, build or rebind after boot, a sabotaged
   window reverted in one config-log CAS with its flight record, and a
   new ladder rung (1024) captured once on the watcher's thread
   mid-drive; ``tenancy``: stacked multi-tenant serving
   (``tenancy.stacked``), config 15's fleets of 2, 4 and 8 MLPs of hidden
   (32, 32) at bucket 8 and 8 tenants of the 1024-wide MLP at buckets 8,
   64 and 512: every tenant's ``scan`` answers byte-equal to its solo
   ``torch`` predictor's, ``vmap`` within its stated tolerance, no capture
   across an eviction, a never-seen admission and a re-admission, the
   stacked replay's device ms against the sequential solo replays';
   ``ab``: ``run_ab_simulation`` of
   ``["linear", "mlp"]`` for 3 days (the MLP's fits at 200 Adam steps),
   the pair concurrently then each
   variant solo, each variant's artefacts byte-identical to its solo
   run, the pair's wall-clock against the sum of the solos;
5. ``day-loop`` — the daily train -> registry gate -> serve -> generate
   -> test loop (``run_simulation``, which journals every day, prefetches
   the horizon's draws, trains each next day as a lookahead on a
   background thread and refreshes the history snapshot; every loop of
   the script fails unless every day used its prefetched draws and every
   day but the first collected its lookahead) for 5 simulated days on the card: the
   MLP at hidden (1024, 1024, 1024) trained with Adam (lr 1e-3, batch 256,
   2000 steps), registered as a candidate, gated, and served from the
   registry's ``production`` alias by ``auto``, which must resolve to
   ``kernel`` every day, with the kernel's launches counted over the loop
   (counts set to 0 just before it, read just after) and the serving
   graph cache cold before it (day 1 must capture its buckets, later days
   none: a new day's checkpoint rebinds the captured graphs); every day's gate
   must have reached a decision and every day's served key must come from
   ``production``. Then the last day's checkpoint through the kernel held
   against its plain version; then a forced rejection on a copy of the
   store (``day-loop-gate-rejection``: a candidate whose metrics fail
   ``min_r2`` is rejected, and the serve stage serves the previous
   production through ``kernel``, launches counted); ``pipelined``: the
   MLP loop's first 2 days against a serial loop of plain ``run_day``
   calls with nothing prefetched or trained ahead, datasets, checkpoints,
   metrics and registry records byte-identical, with each day's train
   stage seconds (the wait for the lookahead), the lookahead's own train
   seconds, the test stage's seconds and what the prefetch box and the
   lookahead's result hold; then the linear
   model's loop (the ``torch`` engine, no kernel). One line per day (the
   engine, the launches, the gate's verdict and seconds, the served key
   and its source, the train and test metrics, the wall-clock and the
   seconds of each stage, and the day's fit and eval row buckets, marked
   where the process meets them first), one line per loop (with its
   bucket-crossing days beside the spread of the other days' fits;
   ``tools/bucket_crossing.py`` fits at buckets no loop reaches), the
   float32 matrix
   product settings in force, and 20 Adam steps at width 1024 from one
   init and one index stream on the card and on the CPU: the first
   step's loss and gradients within 1e-5 (TF32 products must fail both
   bars) and the loss trajectories' largest relative gap; and a profiled
   window of 50 training steps (host time a step, the device's busy
   share, the kernels);
6. ``incremental`` — incremental training on the card: (a) the linear
   loop for 30 days in ``mode="incremental"``, its train seconds a day
   and their last-third over first-third ratio (days 2-30; day 1 builds
   the trainstate and is reported apart), the final coefficients
   within 1e-4 of a float64 refit, and the trainstate bytes equal to the
   same days folded on the CPU (``incremental-linear``), then
   ``snapshot``: a fresh ``cli train`` process on that store must read
   every covered day from the history snapshot, whose load is
   byte-identical to a plain load without it (both cold loads timed, the
   snapshot's bytes printed); (b) the
   1024-wide MLP loop for 5 days, day 1 a full refit, days 2-5 fine-tunes
   of production (500 steps), each gated with 3 shadow days and served
   through ``kernel`` (``incremental-day`` lines, ``incremental-mlp``);
   (c) on a copy of (b)'s store, a day whose fine-tune is made to fail:
   the gate rejects it and the runner refits in full the same day,
   re-gates and serves the refit (``incremental-gate-rejection``); then
   ``quantized``: the serve stage with ``BODYWORK_TPU_SERVE_DTYPE`` at
   ``bfloat16`` and ``int8`` on (b)'s production, which ``auto`` resolves
   to ``kernel``, so the shadow quantization gate must admit
   ``kernel-bf16`` / ``kernel-int8``, whose answers over HTTP are held
   against their plain versions (the gate's report and verdict and the
   launches per kernel printed); and ``quantized-torch``: ``--engine
   torch`` at each dtype (``torch-bf16`` / ``torch-int8``) on the card
   against the same predictor on the CPU;
7. ``resume`` — the 1024-wide MLP day through ``python -m
   bodywork_tpu_torch.cli run-day`` subprocesses: killed by
   ``BODYWORK_TPU_CRASH_SCHEDULE`` at the step boundary after train (exit
   86), restarted (exit 0, train skipped on the journal's digests,
   ``production`` served through ``kernel``), run again (exit 6, a no-op)
   and run under a live foreign lease (exit 5); every artefact
   byte-identical to an uncrashed twin day run in this process, with the
   wall-clocks, the digest re-hash seconds and a day's journal writes;
   then ``sigterm``: SIGTERM to a ``run-day`` mid-train exits 143 with the
   journal ``interrupted``, and the next ``run-day`` resumes the day;
   the killed, restarted and no-op processes must count
   ``runner_resumes_total`` ``fresh``, ``resumed`` and ``noop``; then
   ``day-report``: a ``run-day`` of that day on a fresh store with
   ``--trace-out``/``--report-out``: the report's schema, every stage
   span's trace duration equal to its ``stage_seconds``, the gate and day
   spans, the gate's seconds and the day's seconds outside its stage and
   gate spans; then ``profile``: ``run-sim --profile-dir`` for 1 day of
   the MLP with its fits cut to 200 steps, between two unprofiled runs:
   the trace's CUDA device events, the f32 kernel by name (one event per
   counted launch) or inside graph launches, the trace's bytes and the
   run's seconds with the profiler on and off (the same check runs once
   more right after ``day-loop``, as ``profile-after-day-loop``: the
   first profile after the process's first profiler session);
8. ``audit`` — two 1024-wide MLP days through ``cli run-day --scrub``
   processes (the audited store the command line opens): each day's
   ``fsck:`` line clean, the sidecars by class, each process's seconds
   writing sidecars by the primary's prefix with the replicas' zlib
   apart, each day's wall-clock and train stage; then the port's
   ``run_fsck`` and the JAX package's ``cli fsck --json`` (a CPU
   subprocess) must both find the store clean; ``chaos-sim``:
   ``run_chaos_sim`` over 3 MLP days (fits cut to 200 steps), the stock
   plan, seed 0, both twins on the card, every final artefact
   byte-identical (per prefix), the faults and retries by kind, the
   breaker's opens, each twin's seconds; ``bit-rot``: ``run_bit_rot_sim``
   over 3 MLP days, 100% of the flips detected and classified, the
   repairs by action, the victim byte-identical outside ``quarantine/``;
   ``crash-sim``: ``run_crash_sim`` of 2 linear days at 1 stage boundary
   and 1 seeded store-op point, each child killed there (exit 86) and its
   restart converging, the seconds of each point; ``fleet-sim``:
   ``run_fleet_sim`` of 4 scenario-zoo tenants for 2 days in one store,
   one NaN-sabotaged, linear and then the 1024-wide MLP (fits cut to 200
   steps): every healthy tenant byte-identical to its solo twin, the
   sabotaged gate rejecting, ``kernel``'s launches; ``workers``: ``cli
   serve --workers 2 --metrics`` on the card against a one-process ``cli
   serve``: both worker processes answering the one-process bodies, a
   SIGKILL mid-traffic with zero failed scores and the respawn, a hot
   reload reaching both, the aggregated ``/metrics``, a 64-row burst shed
   by the service-wide budget of 8, one worker's footprint on the card
   (its CUDA context included) and
   the closed-loop requests/s and p50/p99 of both topologies; ``split``:
   ``cli serve --frontends`` on the same checkpoint, torch-free front ends
   and one dispatcher, the one process with a CUDA context: an shm fleet
   of 2 ``aio`` front ends answering config 14's case set with an
   in-process ``cli serve``'s bytes (and the binary framing the JSON
   bytes), ``nvidia-smi --query-compute-apps`` and the processes' open
   NVIDIA device files showing the dispatcher's context alone (its MiB
   printed), ``kernel``'s launches rising in the dispatcher (ready report
   to exit report), config 14's 250 requests/s window merging rows across
   the front ends, the mean flush occupancy at 1 and 2 front ends and
   config 14's verdict on them (``holds``: 2's not below 0.95 of 1's),
   the dispatcher SIGKILLed (503 + ``Retry-After``,
   ``/healthz`` 503, none hung, the respawn healing byte for byte, its
   seconds); a tcp fleet under ``--dtype bfloat16`` answering the
   in-process bf16 bytes on ``kernel-bf16``; config 17's drill on a tcp
   fleet with ``--standby`` and a 1 s leader TTL: a 120 requests/s drive,
   the active dispatcher SIGKILLed at 3 s, the blackout within 6 s (TTL +
   ``RECONNECT_MAX_S``), no hung request and no error but 503, the
   standby's graph captures unchanged by its takeover; ``mesh``: the
   device mesh (``parallel``) on virtual shards of ``cuda:0``, the served
   1024-wide MLP: (a) data-parallel serving at 2x1 and 4x1, buckets 256
   and 4096, byte-equal to a single-device ``torch`` predictor at the
   shard's own bucket (the largest ulp gap to the full-bucket predictor
   printed), each bucket's replay timed; (b) tensor-parallel 1x2 and 2x2
   within 1e-4 of single-device, each shard holding its slice of W0;
   (c) no capture across a same-mesh, same-architecture swap and separate
   graphs for 2x1 and 1x2; (d) ``cli serve --mesh-data 2 --mesh-model 2``
   answering the in-process 2x2 predictor's values, ``/healthz`` ``mesh``
   2x2, the sharded dispatch counter, and under ``--dtype bfloat16`` f32
   serving counted ``unsupported_mesh``; (e) ``train_mlp_sharded`` at the
   loop's settings at 500 Adam steps on 2x2: the index stream bit-equal to
   the CPU's, the
   first step's loss and gradients within 1e-5 of the single-device
   ones on the same draws, the final loss, ``staging_s`` and ``scan_s``
   beside a single-device fit's seconds, the fit then served through
   ``kernel``; (f) one MLP day with the train stage on a 2x2 mesh, gated
   and served; (g) a 1-rank NCCL group through ``multihost_init``: an
   all-reduce and a broadcast on the card, the fit inside the group
   byte-equal to the one without, ``multihost_shutdown``;
9. ``deploy`` — ``cli deploy --out DIR --emit-images DIR2`` of
   ``default_pipeline("mlp")`` with the day loop's 1024-wide MLP in a
   fresh process whose own import log shows no pyyaml, jsonschema or
   torch: both validator layers pass every manifest, every written file
   loads back to the generated document, ``from_yaml(to_yaml(spec)) ==
   spec``; the documents by kind, each pod's ``nvidia.com/gpu`` and
   nodeSelector, the derived image tags and their base images; then
   ``pods``: the emitted manifests run as ``kubectl apply -f`` runs them
   on one store seeded by ``cli generate``: the train, generate and test
   Jobs and the serve Deployment (1 replica) started at once, each its
   initContainer's ``wait-for`` and then its container's command, read
   from the written YAML with only the substitutions printed in
   ``reduced`` (the interpreter, the store mount, the ConfigMap's file,
   the Service's DNS name, and the clocks: the CronJobs run on the day
   after the pods, as a CronJob fires on a later day); the gates must
   order the pods, the serve pod serve on ``kernel`` with its
   ``/healthz`` launches growing across the test Job, the test day's rows
   agree with the served checkpoint's plain version at the ``kernel``
   bar, the test Job's process import no torch (its own import log), and
   SIGTERM end the serve pod as it ends the JAX command; each pod's gate
   wait, start-up and body seconds and the pods' day beside the
   in-process day, and each pod's kernel libraries, loaded from the
   image's prebuilt ``build/torch_kernels/`` or built into or loaded from
   the store's ``.kernel-cache`` (the manifests'
   ``BODYWORK_TPU_COMPILE_CACHE``), with their seconds; then
   ``pods-cronjobs``: each CronJob's command once, the drift gate (exit 0
   or 4 and its table), ``compact``, the ``fsck`` scrub (clean) and
   ``run-day`` of the next date, served on ``kernel``; then
   ``pods-kernel-cache``: every pod's libraries, and two processes with
   the serve pod's env as from an image without the prebuild step; it
   fails unless a library is built at most once and every later pod
   loads, and the first of those two builds into the cache and the
   second loads from it;
10. ``examples`` — the port's eight example scripts (``examples_torch/``,
   the JAX ``examples/`` name for name) on the card in the README's order,
   on one store seeded with the JAX example test's two days, each
   script's ``main()`` run in this process under a patched ``argv`` but
   ``02``, which serves from a process of its own on a free port until
   SIGTERM: 01's MAPE and R^2, 03's rows and 08's first flagged live day
   within the JAX example tests' bars, 04 scoring 03's day through 02 with
   no failure, 02 on the card, 05's report, 06's pair (2 days) and its
   s/day; 07 at full width (hidden (1024, 1024, 1024), 1024 rows, 20
   steps): ``auto`` must serve it on ``kernel``, the f32 kernel's and the
   bf16 kernel's deltas to the f32 apply within the JAX test's bars and
   their answers within ``BARS`` of their plain versions; ``kernel`` and
   ``kernel-bf16`` launched on the path (counts set to 0 before 01, read
   after 08);
11. ``timing``  — per variant at the 256- and 4096-row buckets, with CUDA
   events (warm-up, then the median of 30): the kernel as one call
   (``kernel_ms``) and as replays of a captured CUDA graph, which leaves
   out the host's launch gaps (``kernel_graph_ms``), its plain version,
   and the folded stack through ``torch.addmm`` in the variant's dtype
   with TF32 off (a yardstick the port never calls), eager
   (``library_ms``) and from a graph (``library_graph_ms``), beside the
   card's bound; ``timing-launch-plan`` times every cluster size each
   kernel can take at 256, 512 and 4096 rows; then one ``kernels`` line
   summing every kernel up.

After every phase a ``processes`` line lists what the phase left
running: a live process below the script's (by parent pid in ``/proc``,
or by the run's mark in its environment) still there 10 s after the
phase returned fails that phase, named by pid and command line.
A ``phase-seconds`` line gives each phase's wall-clock seconds (its
process check included; ``day-loop-without-profile`` is ``day-loop``
before its ``profile-after-day-loop``) and a ``total`` line the script's
seconds. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from datetime import date, timedelta

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTHS = (1, 1024, 1024, 1024, 1)  # the served model: hidden (1024, 1024, 1024)
HIDDEN = WIDTHS[1:-1]
VARIANTS = {"kernel": None, "kernel-bf16": "bfloat16", "kernel-int8": "int8"}
SOURCES = {
    "kernel": "bodywork_tpu_torch/ops/csrc/mlp_kernel.cu",
    "kernel-bf16": "bodywork_tpu_torch/ops/csrc/mlp_bf16_tc.cu",
    "kernel-int8": "bodywork_tpu_torch/ops/csrc/mlp_int8.cu",
}
REPLACES = {
    "kernel": "bodywork_tpu/ops/mlp_kernel.py:65",
    "kernel-bf16": "bodywork_tpu/ops/mlp_kernel.py:77",
    "kernel-int8": "bodywork_tpu/ops/mlp_kernel.py:86",
}
#: agreement with the plain version, as max|kernel - plain| / max(1, max|plain|):
#: the f32 and int8 kernels keep the plain arithmetic up to summation
#: order. bf16 rounds every activation, so a change of summation order
#: flips some roundings and moves the output: on an H100, over 4096
#: uniform rows and 8 seeded inits (``tools/bf16_witness.py``), two IEEE
#: f32 orders differ by up to 2.07e-3 of scale, and the kernel, bit-equal
#: there to cuBLAS's bf16 tensor-core GEMM, by up to 2.74e-3 from the
#: plain version. Its bar sits between that and the cheapest control it
#: must refuse (f32 activations, 8.2e-3), near their geometric mean. Each
#: bar must refuse the cheaper arithmetic of :func:`controls` (checked in
#: ``kernels``), so that it tells the kernel's design from a shortcut
BARS = {"kernel": 1e-4, "kernel-bf16": 4.5e-3, "kernel-int8": 1e-4}
KERNEL_ROWS = (1, 8, 300, 4096)
TIMING_ROWS = (256, 4096)
TIMING_REPS = 30
#: The phases' depths (days, Adam steps, drive seconds, windows) are cut
#: so that the whole script keeps within 960 s, 80% of the 1200 s it is
#: given; PERF.md §7 says what each cut no longer shows. Widths are never
#: cut.
#: the day loop: 5 simulated days from this date (days 2 and 4 cross into
#: a new fit bucket, days 3 and 5 do not); the MLP trained with the
#: repository's wide-training settings (``bench.py:1092-1094``)
LOOP_DAYS = 5
LOOP_START = date(2026, 7, 1)
LOOP_MLP = {"hidden": HIDDEN, "learning_rate": 1e-3, "batch_size": 256, "n_steps": 2000}
#: the serial loop the pipelined MLP loop is held to, over its first days
SERIAL_DAYS = 2
#: card against CPU: Adam steps, and the bars on the largest relative
#: gaps of the first step's loss and gradients, computed from the same
#: params on both sides: IEEE float32 differs there by summation order
#: alone (~5e-7 at width 1024 on an H100), TF32 products by ~1e-4 (loss)
#: and ~4e-3 (gradients). The loss trajectory over the 20 steps is
#: printed and has no bar: from the second step on, Adam's ±lr steps
#: carry each rounding difference forward (percents by step 20 on some
#: days' data, in IEEE float32 too)
PARITY_STEPS = 20
PARITY_BARS = {"loss_step0": 1e-5, "grad_step0": 1e-5}
#: Adam steps in the profiled window of the training loop
PROFILE_STEPS = 50
#: the generator phase: every date of this year on the card and the CPU,
#: and this many days timed on the card
GENERATOR_YEAR = date(2026, 1, 1)
GENERATOR_TIMED_DAYS = 30
#: a stack the f32 kernel cannot launch (its widest layer is 1280)
TOO_WIDE = (1, 1344, 1344, 1344, 1)
#: the MLP fit's index stream: over the 7-day loop's padded rows and a
#: count that is not a power of two; timed reps
DRAW_ROWS = (16384, 10000)
DRAW_REPS = 5
#: the incremental linear loop's days, and its coefficients' bar against
#: a float64 refit (``bench.py:2548``)
INC_LINEAR_DAYS = 30
REFIT_ATOL = 1e-4
#: the plain quantized engines on the card against the same predictor on
#: the CPU, as max|card - cpu| / max(1, max|cpu|): int8 differs by f32
#: summation order alone; bf16 also where a bf16 rounding of an activation
#: flips (the JAX package's bf16 bar)
CARD_CPU_BARS = {"torch-int8": 1e-4, "torch-bf16": 2e-2}
#: serve-graph-overlap: Adam steps on the training thread beside the capture
OVERLAP_STEPS = 800
#: serve-coalesce: the JAX benchmark's config 7 (``bench.py:646``)
COALESCE = {"sequential": 300, "clients": 16, "per_client": 25, "windows": (0, 2.0),
            "max_rows": 64}
#: serve-admission: the aio budget and the burst past it
ADMISSION = {"max_pending": 8, "burst": 64}
#: trace: single rows sent one after another, the batch's rows, the
#: ingress traceparent, and the trace fractions config 7 is served at, in
#: turns (each fraction twice, mirrored: the spread between calls is wide)
TRACE = {"singles": 20, "batch_rows": 4096, "ingress": f"00-{'4b' * 16}-{'9c' * 8}-01",
         "fractions": (0.0, 0.1, 1.0, 1.0, 0.1, 0.0)}
#: profile: the 1-day MLP simulation and its Adam steps a fit, cut from
#: the loop's 2000 so the profile holds ~25k kernel events a day, not ~125k
PROFILE_SIM = {"days": 1, "n_steps": 200}
#: traffic: config 9's load factors and rate cap (``bench.py:1550-1554``),
#: its coalescer and closed-loop probe, seconds a point, the log's seed,
#: the sharded driver's processes (bench.py's ``driver_shards``)
TRAFFIC = {"factors": (0.5, 1.0, 2.0), "cap_rps": 2000.0, "duration_s": 3.0,
           "window_ms": 2.0, "max_rows": 64, "probe_clients": 16, "probe_s": 3.0, "seed": 9,
           "shards": 4}
#: reload: config 11's swap (``bench.py:1983``) at 0.5x capacity, the
#: promotion this far into the drive, the watcher's poll, and the send-lag
#: p99 past which the drive, not the service, is at fault
RELOAD = {"factor": 0.5, "duration_s": 6.0, "swap_at_s": 2.0, "poll_s": 0.5,
          "max_send_lag_ms": 50.0}
#: canary: the chaos acceptance's requests and canary fraction (its defaults)
CANARY = {"requests": 240, "fraction": 0.35}
#: ab: the A/B simulation's days
AB = {"days": 3}
#: config 13's self-tuning shape (``bench.py:3032-3140``): the uniform_row
#: and heavy_tail_row profiles, each driven 4 s (not 8), the probe's rungs
TUNE = {"drive_s": 4.0, "uniform_rps": 150.0, "heavy_rps": 40.0, "heavy_rows": 700,
        "probe_buckets": "1,8,64,256,512,1024,4096", "probe_reps": 5, "cost_budget_s": 4.0,
        "cost_holdout_bound": 0.5}
#: config 18's online tuning shape (``bench.py:4623-4645``), then a new rung
ONLINE_TUNE = {"poll_s": 0.25, "phase_a_s": 5.0, "phase_a_rps": 60.0, "phase_b_s": 5.0,
               "phase_b_rps": 180.0, "min_window_requests": 60, "min_verdict_requests": 15,
               "verdict_polls": 40, "cooldown_polls": 2, "revert_p99_ratio": 12.0,
               "sabotage_window_ms": 900.0, "calibration_s": 2.5, "calibration_rps": 40.0,
               "sabotage_drive_s": 4.0, "sabotage_rps": 40.0, "probe_reps": 3,
               "cost_budget_s": 4.0, "new_rung": 1024, "rung_drive_s": 4.0, "rung_rps": 60.0,
               "slow_factor": 5.0}
#: the store-integrity and chaos soaks: the loop's 1024-wide MLP,
#: its fits in the soaks cut to the profile's 200 Adam steps; so are the
#: MLP days of ``resume``, ``day-report``, ``audit`` and ``pods``, the
#: canary's two checkpoints a scenario and the A/B pair's MLP (``sigterm``
#: keeps 2000, since it signals 1 s into the Adam loop)
SOAK_MLP = {**LOOP_MLP, "n_steps": PROFILE_SIM["n_steps"]}
SOAK_DAYS = 3
#: what the soaks cut from the loop's configuration
_SOAK_REDUCED = [f"Adam steps per fit {LOOP_MLP['n_steps']} -> {SOAK_MLP['n_steps']}"]
AUDIT_DAYS = 2
#: the crash sweep on the card: 2 linear days, 1 of its 10 stage
#: boundaries and 1 seeded store-op point (2 and 2 until the split phase
#: joined the script: the script keeps within ~900 s)
CRASH = {"days": 2, "boundaries": (7,), "store_op_samples": 1, "seed": 0}
#: tenancy: config 15's shape (bench.py: fleets of 2/4/8, 8 rows a tenant,
#: bucket 8, hidden (32, 32)), then 8 tenants of the served width
TENANCY = {"fleet_sizes": (2, 4, 8), "small_widths": (1, 32, 32, 1), "small_buckets": (8,),
           "small_rows": 8, "wide_tenants": 8, "wide_buckets": (8, 64, 512)}
FLEET = {"tenants": 4, "days": 2, "sabotage": "tenant-01", "samples_per_day": 1440}
#: mesh: the virtual shards of cuda:0, the serving buckets and meshes,
#: tensor parallelism's bar (the JAX test's, tests/test_sharded_serve.py),
#: the sharded fit's mesh and the first step's bar (PARITY_BARS'), the
#: 1-rank group's fit steps
MESH = {"virtual": 4, "dp": ((2, 1), (4, 1)), "tp": ((1, 2), (2, 2)), "buckets": (256, 4096),
        "tp_bar": 1e-4, "fit": (2, 2), "step0_bar": 1e-5, "group_steps": 100}
#: the sharded fit, its single-device yardstick and the mesh day: the
#: loop's MLP at 500 Adam steps
MESH_MLP = {**LOOP_MLP, "n_steps": 500}
#: (6 closed-loop clients stay under the budget of 8: the load drive sheds nothing)
WORKERS = {"workers": 2, "max_pending": 8, "burst": 64, "clients": 6, "per_client": 50,
           "drill_requests": 40, "kill_at": 10, "reload_s": 0.5}


#: examples: the port's example scripts on one store seeded with the JAX
#: example test's days; the A/B example's days (the JAX test's; the
#: script's default is 7)
EXAMPLES = {"seed_days": 2, "seed_start": date(2026, 1, 1), "ab_days": 2}
#: the JAX example test's bars (``tests/test_examples.py``)
EXAMPLE_BARS = {"MAPE": (0.5, 1.2), "r_squared": (0.55, 0.75), "rows": (1200, 1440),
                "live_day": (35, 53), "f32_delta": 0.01, "bf16_rel": 0.05}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


#: set by ``main`` to its pid; every process the script starts inherits it,
#: so one whose parent ended (and which left the process tree) is still
#: found as the run's
RUN_ENV = "BODYWORK_TPU_SMOKE_RUN"
#: seconds a process the phase started has to end after the phase returned
PROCESS_GRACE_S = 10.0


def _proc_read(path: str) -> bytes:
    """A ``/proc`` file's bytes, empty once its process is gone."""
    try:
        with open(f"/proc/{path}", "rb") as f:
            return f.read()
    except OSError:
        return b""


def _descendants() -> list:
    """The live processes below this one, read from each
    ``/proc/<pid>/stat``'s parent pid, with those whose environment holds
    ``RUN_ENV`` set to this pid: ``[{"pid", "ppid", "cmdline"}]``. Zombies
    (ended, not yet reaped) are left out, and so is this process's
    multiprocessing resource tracker, which lives as long as the process
    that started it. Reads ``/proc`` and changes nothing."""
    from multiprocessing import resource_tracker

    root = os.getpid()
    tracker = getattr(resource_tracker._resource_tracker, "_pid", None)
    parent = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        stat = _proc_read(f"{pid}/stat").decode(errors="replace")
        if stat:
            state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
            if state != "Z":
                parent[int(pid)] = int(ppid)
    below, grew = {root}, True
    while grew:
        grew = False
        for pid, ppid in parent.items():
            if ppid in below and pid not in below:
                below.add(pid)
                grew = True
    marker = f"\0{RUN_ENV}={root}\0".encode()
    below |= {pid for pid in parent if pid not in below
              and marker in b"\0" + _proc_read(f"{pid}/environ")}
    return [{"pid": pid, "ppid": parent[pid],
             "cmdline": _proc_read(f"{pid}/cmdline").replace(b"\0", b" ").decode(
                 errors="replace").strip()[:300]}
            for pid in sorted(below - {root, tracker}) if pid in parent]


def _loadavg() -> list:
    """``/proc/loadavg``'s three load averages and its runnable/total."""
    return _proc_read("loadavg").decode().split()[:4]


def _check_processes(phase: str) -> None:
    """Fail ``phase`` if it left a process behind: a descendant of this
    process (:func:`_descendants`) still alive ``PROCESS_GRACE_S`` after
    the phase returned, named by pid and command line. Prints one
    ``processes`` line: those left, and those that ended in the grace."""
    t0 = time.perf_counter()
    first = left = _descendants()
    while left and time.perf_counter() - t0 < PROCESS_GRACE_S:
        time.sleep(0.1)
        left = _descendants()
    alive = {p["pid"] for p in left}
    emit("processes", after=phase, left=left,
         ended_in_grace=[p for p in first if p["pid"] not in alive],
         seconds=time.perf_counter() - t0)
    if left:
        raise RuntimeError(f"{phase} left {len(left)} process(es) behind: " + "; ".join(
            f"pid {p['pid']} (parent {p['ppid']}): {p['cmdline']}" for p in left))


def peaks(name: str) -> dict:
    """Published dense peaks of the card (NVIDIA data sheets): f32 on the
    CUDA cores, TF32 and bf16 on the tensor cores (PCIe and NVL: half the
    sheet's with-sparsity figure), and the memory rate."""
    if "PCIe" in name:
        return {"part": "H100 PCIe", "f32": 51e12, "tf32": 378e12, "bf16": 756e12,
                "bytes_s": 2.0e12}
    if "NVL" in name:
        return {"part": "H100 NVL", "f32": 60e12, "tf32": 417.5e12, "bf16": 835e12,
                "bytes_s": 3.9e12}
    return {"part": "H100 SXM", "f32": 67e12, "tf32": 495e12, "bf16": 989e12,
            "bytes_s": 3.35e12}


def f32_product_ms(rows: int, card: dict) -> dict:
    """The two ways to run f32-accurate products on the card, in ms for
    one forward of ``rows`` rows: FFMA on the CUDA cores (2 operations a
    MAC at the f32 peak) and 3xTF32 on the tensor cores (three TF32
    products a MAC, 2 operations each, at the dense TF32 peak)."""
    macs = rows * sum(k * n for k, n in zip(WIDTHS[:-1], WIDTHS[1:]))
    return {"ffma_ms": 1e3 * 2 * macs / card["f32"],
            "tf32x3_ms": 1e3 * 3 * 2 * macs / card["tf32"]}


def bound(rows: int, engine: str, card: dict) -> tuple[float, str]:
    """The least time the card could take for one forward of ``rows``
    rows: the larger of its bytes (X read once, weights/biases/scales read
    once, the head written once) over the memory rate, and its operations
    over the peak rate for the operands' type. The f32 and int8 kernels
    need f32-accurate products: the faster of FFMA and 3xTF32
    (:func:`f32_product_ms`); the bf16 operands' peak is the tensor
    cores'."""
    pairs = list(zip(WIDTHS[:-1], WIDTHS[1:]))
    macs = rows * sum(k * n for k, n in pairs)
    weight_bytes = {"kernel": 4, "kernel-bf16": 2, "kernel-int8": 1}[engine]
    nbytes = (
        rows * WIDTHS[0] * 4 + sum(k * n for k, n in pairs) * weight_bytes
        + sum(n for _, n in pairs) * 4 * (2 if engine == "kernel-int8" else 1)
        + rows * 4
    )
    if engine == "kernel-bf16":
        t_ops = 2 * macs / card["bf16"]
    else:
        t_ops = 1e-3 * min(f32_product_ms(rows, card).values())
    t_bytes = nbytes / card["bytes_s"]
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> tuple[float, float]:
    diff = float((got - want).abs().max())
    return diff, diff / max(1.0, float(want.abs().max()))


def bf16_exact(torch, layers, X):
    """The bf16 variant's function with exact sums: each layer's input
    rounded to bf16 as the kernel rounds it, then float64 products and
    sums rounded once to f32 (an order-free witness)."""
    h = X.to(torch.float32)
    for i, layer in enumerate(layers):
        h = (h.to(torch.bfloat16).double() @ layer["w"].double()
             + layer["b"].double()).to(torch.float32)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[:, 0]


def bf16_library(torch, layers, X):
    """The bf16 variant's function through cuBLAS's bf16 tensor-core GEMM
    with f32 output (``torch.mm(..., out_dtype=torch.float32)``), or None
    where this PyTorch lacks it. A witness only: the port never calls it."""
    h = X.to(torch.float32)
    try:
        for i, layer in enumerate(layers):
            h = torch.mm(h.to(torch.bfloat16), layer["w"].to(torch.bfloat16),
                         out_dtype=torch.float32) + layer["b"]
            if i < len(layers) - 1:
                h = torch.relu(h)
    except (RuntimeError, TypeError):
        return None
    return h[:, 0]


def controls(torch, layers, X, dtype) -> dict:
    """The variant's function computed with cheaper arithmetic than its
    kernel claims, in plain torch ops: TF32 products (f32, int8), int8
    weights times activations rounded to bf16, and for bf16 activations
    left unrounded or weights rounded to fp8 (e4m3). Each one's output."""
    from bodywork_tpu_torch.ops.mlp_kernel import mlp_stack_plain

    if dtype == "bfloat16":
        fp8 = [{"w": layer["w"].to(torch.float8_e4m3fn).float(), "b": layer["b"]}
               for layer in layers]
        return {"f32-activations": mlp_stack_plain(layers, X, None),
                "fp8-weights": mlp_stack_plain(fp8, X, "bfloat16")}
    if dtype == "int8":
        layers = [{"w": layer["w"].float() * layer["scale"][None, :], "b": layer["b"]}
                  for layer in layers]
    out = {}
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out["tf32"] = mlp_stack_plain(layers, X, None)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    if dtype == "int8":
        out["bf16-activations"] = mlp_stack_plain(layers, X, "bfloat16")
    return out


def make_params(torch, dev, X: "torch.Tensor", y: "torch.Tensor", seed: int = 0,
                widths: tuple = WIDTHS) -> dict:
    """Seeded He-init weights (the JAX fit's threefry init for ``seed``)
    and the scaler's statistics over the generated days."""
    from bodywork_tpu_torch.models.mlp import _masked_stats, fit_keys, init_mlp_params

    net = init_mlp_params(fit_keys(seed)[0], widths, device=dev)
    w = torch.ones(X.shape[0], device=dev)
    x_mean, x_std = _masked_stats(X, w)
    y_mean, y_std = _masked_stats(y, w)
    return {
        "net": net,
        "scaler": {"x_mean": x_mean[None], "x_std": x_std[None],
                   "y_mean": y_mean, "y_std": y_std},
    }


def post(url: str, payload) -> dict:
    request = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(request, timeout=60) as resp:
        return json.loads(resp.read())


def post_raw(url: str, payload) -> bytes:
    """The response body of a JSON POST, byte for byte."""
    request = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(request, timeout=60) as resp:
        return resp.read()


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def phase_device(torch, watchdog_s: float | None = None) -> dict:
    """The card's name, capability and ``nvidia-smi`` line; ``main`` runs
    it under the bring-up watchdog, whose seconds the line prints."""
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit("device", name=name, capability=list(cap), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         watchdog_s=watchdog_s)
    print(smi, flush=True)
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"expected a Hopper card (capability 9.0), got {cap}")
    return {"name": name, "smi": smi, **peaks(name)}


def _ulps(torch, a: "torch.Tensor", b: "torch.Tensor") -> int:
    """The most float32 ulps between two arrays of draws."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def phase_generator(torch, dev) -> dict:
    """The drift generator's draws for every date of 2026, on the card
    and on the CPU: ``X`` and the kept-row mask must be bit-equal."""
    from bodywork_tpu_torch.data import prng
    from bodywork_tpu_torch.data.drift_config import DriftConfig
    from bodywork_tpu_torch.data.generator import _sample_day, generate_day, key_for_date
    from bodywork_tpu_torch.utils.dates import day_of_year

    cfg = DriftConfig()

    def draws(d, device):  # generate_day's draws, before the mask's compaction
        bits = prng.random_bits(prng.split(key_for_date(d, cfg, device=device)), cfg.n_samples)
        x = prng.uniform_from_bits(bits[0], cfg.x_low, cfg.x_high)
        eps = prng.normal_from_bits(bits[1])
        return eps, _sample_day(x, eps, day_of_year(d), cfg)

    dates = [GENERATOR_YEAR + timedelta(days=i) for i in range(365)]
    x_equal = mask_equal = eps_equal = y_equal = 0
    eps_ulps = y_ulps = 0
    for d in dates:
        eps_card, card = (t.cpu() for t in draws(d, dev))
        eps_cpu, cpu = draws(d, torch.device("cpu"))
        x_equal += bool(torch.equal(card[0].view(torch.int32), cpu[0].view(torch.int32)))
        mask_equal += bool(torch.equal(card[2], cpu[2]))
        eps_equal += bool(torch.equal(eps_card.view(torch.int32), eps_cpu.view(torch.int32)))
        y_equal += bool(torch.equal(card[1].view(torch.int32), cpu[1].view(torch.int32)))
        eps_ulps = max(eps_ulps, _ulps(torch, eps_card, eps_cpu))
        y_ulps = max(y_ulps, _ulps(torch, card[1], cpu[1]))
    times = []
    for d in dates[:GENERATOR_TIMED_DAYS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_day(d, cfg, device=dev)  # ends on the device-to-host copy
        times.append(time.perf_counter() - t0)
    out = {"dates": len(dates), "x_bit_equal": x_equal, "mask_equal": mask_equal,
           "eps_bit_equal": eps_equal, "y_bit_equal": y_equal,
           "eps_max_ulps": eps_ulps, "y_max_ulps": y_ulps,
           "generate_day_ms_median": 1e3 * statistics.median(times),
           "generate_day_timed_days": len(times)}
    emit("generator", **out)
    if x_equal != len(dates) or mask_equal != len(dates):
        raise RuntimeError(f"the card's draws differ from the CPU's: {out}")
    return out


def phase_build() -> None:
    from bodywork_tpu_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    seconds = time.perf_counter() - t0
    report = {
        name: [line.strip() for line in r["log"].splitlines()
               if "registers" in line or "spill" in line or "Compiling entry" in line
               or "warning" in line.lower() or "Performance Loss" in line]
        for name, r in info.items()
    }
    emit("build", seconds=seconds,
         libraries={n: {"built": r["built"], "nvcc_seconds": r["seconds"]} for n, r in info.items()},
         ptxas=report)


def phase_kernels(torch, dev) -> dict:
    from bodywork_tpu_torch.ops.mlp_kernel import (
        LAUNCHES,
        make_kernel_mlp_apply,
        mlp_stack_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    X_all = torch.rand(4096, 1, generator=gen, device=dev) * 100.0
    params = make_params(torch, dev, X_all[:, 0], 0.5 * X_all[:, 0] + 1.0)
    errors = {}
    for engine, dtype in VARIANTS.items():
        apply = make_kernel_mlp_apply(params, dev, compute_dtype=dtype)
        before = LAUNCHES[engine]
        per_rows = {}
        for rows in KERNEL_ROWS:
            X = X_all[:rows]
            got = apply(X)
            want = mlp_stack_plain(apply.layers, X, dtype)
            torch.cuda.synchronize()
            if got.shape != (rows,) or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{engine}: bad output at {rows} rows")
            max_abs, rel = rel_err(got, want)
            per_rows[rows] = {"max_abs_err": max_abs, "err_over_scale": rel}
            if rel >= BARS[engine]:
                raise RuntimeError(
                    f"{engine} disagrees with its plain version at {rows} rows: "
                    f"{rel:.3g} >= {BARS[engine]}"
                )
        launched = LAUNCHES[engine] - before
        if launched != len(KERNEL_ROWS):
            raise RuntimeError(f"{engine}: {launched} launches for {len(KERNEL_ROWS)} calls")
        errors[engine] = per_rows[4096]["max_abs_err"]
        # the bar must refuse each cheaper arithmetic, on the last batch
        # (4096 rows)
        control_errs = {name: rel_err(c, want)[1]
                        for name, c in controls(torch, apply.layers, X, dtype).items()}
        passing = [name for name, rel in control_errs.items() if rel < BARS[engine]]
        if passing:
            raise RuntimeError(f"{engine}: the bar {BARS[engine]} does not refuse "
                               f"{passing}: {control_errs}")
        witnesses = {}
        if dtype == "bfloat16":
            # two more witnesses on the last batch: exact sums, held to the
            # bar too, and cuBLAS's tensor cores (reported)
            got = apply(X)
            witnesses["exact_f64"] = rel_err(got, bf16_exact(torch, apply.layers, X))[1]
            library = bf16_library(torch, apply.layers, X)
            if library is not None:
                witnesses["library_tc"] = rel_err(got, library)[1]
                witnesses["bit_equal_to_library_tc"] = bool(torch.equal(got, library))
            if witnesses["exact_f64"] >= BARS[engine]:
                raise RuntimeError(f"{engine} disagrees with exact sums: {witnesses}")
        emit("kernels", engine=engine, bar=BARS[engine], rows=per_rows,
             controls=control_errs, witnesses=witnesses,
             **_launch_shape(apply, KERNEL_ROWS))
        _check_ragged(torch, dev, engine, dtype)
    torch.cuda.synchronize()
    return errors


def _launch_shape(apply, rows_list) -> dict:
    """What each launch of ``apply`` looks like per batch size: [row tile,
    cluster size, ring stages (0 where the source fixes its ring), dynamic
    shared memory bytes a CTA]."""
    plans = {rows: apply.launch.plan(rows) for rows in rows_list}
    return {"launch_plan": {
        rows: [p.rows_per_tile, p.cluster, p.stages, p.smem_bytes] for rows, p in plans.items()
    }}


def _check_ragged(torch, dev, engine: str, dtype) -> None:
    """The kernels' other paths at small cost: 3 features, ragged widths
    and a 1100-wide layer, held against the plain version at the kernel's
    row tile and every cluster size the card schedules for it. Each kernel
    must refuse a 2048-wide layer, past its shared-memory limit (1280
    features for f32, 1536 for bf16, 1600 for int8: the headers of their
    sources)."""
    from bodywork_tpu_torch.data.prng import PRNGKey
    from bodywork_tpu_torch.models.mlp import init_mlp_params
    from bodywork_tpu_torch.ops.mlp_kernel import (
        CLUSTER_KERNELS,
        make_kernel_mlp_apply,
        mlp_stack_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def params_for(widths):
        return {
            "net": init_mlp_params(PRNGKey(sum(widths)), widths, device=dev),
            "scaler": {"x_mean": torch.full((widths[0],), 50.0, device=dev),
                       "x_std": torch.full((widths[0],), 29.0, device=dev),
                       "y_mean": torch.tensor(26.0, device=dev),
                       "y_std": torch.tensor(15.0, device=dev)},
        }

    params = params_for((3, 1100, 40, 1))
    X = torch.rand(37, 3, generator=gen, device=dev) * 100.0
    rows = CLUSTER_KERNELS[engine].rows
    probe = make_kernel_mlp_apply(params, dev, compute_dtype=dtype, block_rows=rows)
    shapes = [{"block_rows": rows, "cluster": c} for c in sorted(probe.launch.clusters)]
    refuse = dict(params=params_for((3, 2048, 1)), block_rows=rows)
    worst = 0.0
    for shape in shapes:
        apply = make_kernel_mlp_apply(params, dev, compute_dtype=dtype, **shape)
        worst = max(worst, rel_err(apply(X), mlp_stack_plain(apply.layers, X, dtype))[1])
    torch.cuda.synchronize()
    if worst >= BARS[engine]:
        raise RuntimeError(f"{engine} disagrees on the ragged stack: {worst:.3g}")
    try:
        make_kernel_mlp_apply(refuse["params"], dev, compute_dtype=dtype,
                              block_rows=refuse["block_rows"])
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise RuntimeError(f"{engine}: a stack past its shared memory was not refused")
    emit("kernels-ragged", engine=engine, widths=[3, 1100, 40, 1], rows=37,
         shapes=shapes, err_over_scale=worst, refused=refusal)


def _serve_path(torch, dev, store, engine: str, singles, batches) -> dict:
    """Serve the store's newest checkpoint through ``engine``, send the
    requests over HTTP and hold every answer against the plain version.
    Returns the handle (started) and the check summary."""
    from bodywork_tpu_torch.serve import serve_latest_model

    handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                engine=engine, device=dev)
    return (handle, *_check_served(torch, dev, handle, singles, batches))


def _check_served(torch, dev, handle, singles, batches) -> tuple[dict, dict]:
    """Send the requests over HTTP to a started kernel service and hold
    every answer against the kernel's plain version; returns ``/healthz``
    and the check summary."""
    from bodywork_tpu_torch.ops.mlp_kernel import mlp_stack_plain

    health = get(handle.base_url + "/healthz")
    predictor = handle.app.predictor
    layers, dtype = predictor.kernel.layers, {"float32": None}.get(predictor.dtype, predictor.dtype)
    worst = 0.0
    latencies = []
    for x in singles:
        t0 = time.perf_counter()
        got = post(handle.url, {"X": x})["prediction"]
        latencies.append(time.perf_counter() - t0)
        want = mlp_stack_plain(layers, torch.tensor([[x]], device=dev), dtype)
        worst = max(worst, rel_err(torch.tensor([got], device=dev), want)[1])
    for X in batches:
        body = post(handle.url + "/batch", {"X": X.tolist()})
        got = torch.tensor(body["predictions"], device=dev)
        if body["n"] != len(X) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{engine}: bad batch answer for {len(X)} rows")
        worst = max(worst, rel_err(got, mlp_stack_plain(layers, X[:, None], dtype))[1])
    return health, {"worst_err_over_scale": worst,
                    "single_latency_ms": [1e3 * t for t in latencies]}


def phase_slice(torch, dev, workdir: str) -> dict:
    import numpy as np

    from bodywork_tpu_torch.data import Dataset, generate_day, load_latest_dataset, persist_dataset
    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor, save_model
    from bodywork_tpu_torch.monitor import HttpScoringClient, run_service_test, scoring_endpoint
    from bodywork_tpu_torch.monitor.tester import DEFAULT_BATCH_SIZE
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import test_metrics_key as metrics_key

    store = FilesystemStore(os.path.join(workdir, "store"))
    days = [date(2026, 7, d) for d in (1, 2, 3)]
    Xs, ys = [], []
    for d in days:
        X, y = generate_day(d, device=dev)
        persist_dataset(store, Dataset(X, y, d))
        Xs.append(X)
        ys.append(y)
    X_hist = torch.as_tensor(np.concatenate(Xs), device=dev)
    y_hist = torch.as_tensor(np.concatenate(ys), device=dev)
    model = MLPRegressor(MLPConfig(hidden=HIDDEN), make_params(torch, dev, X_hist, y_hist))
    save_model(store, model, days[-1])
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    batches = [torch.rand(n, generator=gen, device=dev) * 100.0 for n in (300, 4096)]
    singles = [50.0, 10.0, 90.0]
    launches = {}

    # the main path: engine auto -> kernel, then the test stage over HTTP
    reset_launches()
    handle, health, checks = _serve_path(torch, dev, store, "auto", singles, batches)
    try:
        if health["engine"] != "kernel" or health["device"] != "cuda":
            raise RuntimeError(f"auto served {health['engine']} on {health['device']}")
        if checks["worst_err_over_scale"] >= BARS["kernel"]:
            raise RuntimeError(f"served answers disagree with the plain version: {checks}")
        client = HttpScoringClient(scoring_endpoint(handle.url, "batch"))
        t0 = time.perf_counter()
        metrics = run_service_test(store, client, mode="batch")
        test_seconds = time.perf_counter() - t0
    finally:
        handle.stop()
    launches["kernel"] = LAUNCHES["kernel"]
    n_rows = len(load_latest_dataset(store))
    n_requests = len(singles) + len(batches) + -(-n_rows // DEFAULT_BATCH_SIZE)
    if not store.exists(metrics_key(days[-1])) or metrics["n_failures"] != 0:
        raise RuntimeError(f"test stage failed: {metrics}")
    if metrics["n_scored"] != n_rows:
        raise RuntimeError(f"test stage scored {metrics['n_scored']} of {n_rows} rows")
    if launches["kernel"] < n_requests:
        raise RuntimeError(f"{launches['kernel']} kernel launches for {n_requests} requests")
    emit("slice", engine=health["engine"], device=health["device"],
         model_info=health["model_info"], model_key=health["model_key"],
         requests=n_requests, launches=launches["kernel"], test_rows=n_rows,
         test_seconds=test_seconds,
         test_metrics={k: (str(v) if isinstance(v, date) else v) for k, v in metrics.items()},
         **checks)

    # the other two kernels serve the same checkpoint on their own paths
    for engine in ("kernel-bf16", "kernel-int8"):
        reset_launches()
        handle, health, checks = _serve_path(torch, dev, store, engine, singles[:2], batches[:1])
        handle.stop()
        launches[engine] = LAUNCHES[engine]
        if health["engine"] != engine or checks["worst_err_over_scale"] >= BARS[engine]:
            raise RuntimeError(f"{engine} path failed: {health} {checks}")
        if launches[engine] < 3:
            raise RuntimeError(f"{engine}: {launches[engine]} launches for 3 requests")
        emit(f"slice-{engine.split('-')[1]}", engine=engine, launches=launches[engine], **checks)
    _serve_too_wide(torch, dev, X_hist, y_hist, batches[0])
    _serve_nan_model(torch, dev, X_hist, y_hist)
    torch.cuda.synchronize()
    return launches


def _serve_too_wide(torch, dev, X_hist, y_hist, X) -> None:
    """A stack the f32 kernel cannot launch, on ``auto``: the plan-time
    check must pick the ``torch`` engine, which serves it on the card."""
    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor
    from bodywork_tpu_torch.models.mlp import mlp_apply
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import serve_model

    model = MLPRegressor(MLPConfig(hidden=TOO_WIDE[1:-1]),
                         make_params(torch, dev, X_hist, y_hist, widths=TOO_WIDE))
    reset_launches()
    handle = serve_model(model, None, host="127.0.0.1", port=0, block=False, engine="auto")
    try:
        health = get(handle.base_url + "/healthz")
        got = torch.tensor(post(handle.url + "/batch", {"X": X.tolist()})["predictions"],
                           device=dev)
    finally:
        handle.stop()
    launched = sum(LAUNCHES.values())
    with torch.no_grad():
        want = mlp_apply(model.params, X[:, None])
    err = rel_err(got, want)[1]
    emit("slice-auto-wide", hidden=list(TOO_WIDE[1:-1]), engine=health["engine"],
         device=health["device"], launches=launched, rows=int(X.shape[0]),
         err_over_scale_vs_plain=err)
    if health["engine"] != "torch" or health["device"] != "cuda" or launched:
        raise RuntimeError(f"auto on a too-wide stack: {health} ({launched} launches)")
    if err >= BARS["kernel"] or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"the torch engine's answers disagree: {err:.3g}")


def _serve_nan_model(torch, dev, X_hist, y_hist) -> None:
    """A model whose output is NaN, served through the f32 kernel: the
    prediction-sanity firewall must answer 500 over HTTP, without the
    value, for a single row and a batch."""
    import urllib.error

    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import serve_model

    params = make_params(torch, dev, X_hist, y_hist)
    params["net"]["layers"][-1]["b"] = torch.full_like(params["net"]["layers"][-1]["b"],
                                                       float("nan"))
    model = MLPRegressor(MLPConfig(hidden=HIDDEN), params)
    reset_launches()
    handle = serve_model(model, None, host="127.0.0.1", port=0, block=False, engine="auto",
                         model_source="production")
    answers = []
    try:
        health = get(handle.base_url + "/healthz")
        for url, body in ((handle.url, {"X": 50.0}), (handle.url + "/batch", {"X": [1.0, 2.0]})):
            try:
                post(url, body)
                answers.append((200, b""))
            except urllib.error.HTTPError as exc:
                answers.append((exc.code, exc.read()))
    finally:
        handle.stop()
    launched = LAUNCHES["kernel"]
    emit("slice-nan", engine=health["engine"], launches=launched,
         statuses=[code for code, _ in answers], bodies=[b.decode() for _, b in answers])
    if health["engine"] != "kernel" or launched < 2:
        raise RuntimeError(f"the NaN model was not served through the kernel: {health}")
    if any(code != 500 or b"nan" in body.lower() for code, body in answers):
        raise RuntimeError(f"a NaN prediction was not refused: {answers}")


# -- the serving machinery: graph cache, coalescer, admission, aio ------------

def _connect(base_url: str):
    """A keep-alive HTTP/1.1 connection to a service (one per client)."""
    import http.client
    from urllib.parse import urlsplit

    parts = urlsplit(base_url)
    return http.client.HTTPConnection(parts.hostname, parts.port, timeout=60)


def _score(conn, x: float) -> tuple[int, dict, bytes, float]:
    """One single-row ``/score/v1`` on a keep-alive connection: status,
    headers, body and seconds."""
    status, headers, _sent, payload, seconds = _post_json(conn, "/score/v1", {"X": x})
    return status, headers, payload, seconds


def _post_json(conn, path: str, payload, headers=None) -> tuple[int, dict, bytes, bytes, float]:
    """One POST of ``payload`` as JSON on a keep-alive connection: status,
    headers, the request body sent, the response body, and seconds."""
    body = json.dumps(payload).encode()
    t0 = time.perf_counter()
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    payload = resp.read()
    return resp.status, dict(resp.getheaders()), body, payload, time.perf_counter() - t0


def _nearest_rank(values, q: float) -> float:
    """Nearest-rank percentile (the JAX benchmark's ``_percentile``)."""
    ordered = sorted(values)
    return ordered[min(int(round(q / 100.0 * (len(ordered) - 1))), len(ordered) - 1)]


def _serving_models(torch, dev, workdir: str):
    """The served 1024-wide MLP (seed 0) checkpointed in a store of three
    generated days, and a second checkpoint of the same architecture
    (seed 1) in memory."""
    import numpy as np

    from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor, save_model
    from bodywork_tpu_torch.store import FilesystemStore

    store = FilesystemStore(os.path.join(workdir, "serving-store"))
    Xs, ys = [], []
    for d in (date(2026, 7, 1), date(2026, 7, 2), date(2026, 7, 3)):
        X, y = generate_day(d, device=dev)
        persist_dataset(store, Dataset(X, y, d))
        Xs.append(X)
        ys.append(y)
    X_hist = torch.as_tensor(np.concatenate(Xs), device=dev)
    y_hist = torch.as_tensor(np.concatenate(ys), device=dev)
    first = MLPRegressor(MLPConfig(hidden=HIDDEN), make_params(torch, dev, X_hist, y_hist))
    save_model(store, first, date(2026, 7, 3))
    second = MLPRegressor(MLPConfig(hidden=HIDDEN),
                          make_params(torch, dev, X_hist, y_hist, seed=1))
    return store, second, (X_hist, y_hist)


def _bucket_checks(torch, dev, predictor, engine: str, seed: int) -> dict:
    """Per bucket of a warmed kernel predictor, on a full bucket of seeded
    uniform rows: its graph replay against the same predictor's eager
    kernel launch on the same input (bit-equal: the graph's contract) and
    within the engine's bar of the plain version; then the host
    milliseconds a request's dispatch takes at that bucket, eager (host
    batch to the card, one launch, read back: the dispatch before the
    graph cache) against the graph (staging, replay, read back), medians
    of TIMING_REPS in turns."""
    import numpy as np

    from bodywork_tpu_torch.ops.mlp_kernel import mlp_stack_plain

    dtype = {"float32": None}.get(predictor.dtype, predictor.dtype)
    rng = np.random.default_rng(seed)
    out = {}
    for b in predictor.buckets:
        Xp = rng.uniform(0, 100, (b, 1)).astype(np.float32)
        replay = predictor._predict_padded(Xp)
        X = torch.as_tensor(Xp, device=dev)
        eager = predictor.kernel(X).cpu().numpy()
        plain = mlp_stack_plain(predictor.kernel.layers, X, dtype)
        rel = rel_err(torch.as_tensor(replay, device=dev), plain)[1]
        times = {"eager": [], "graph": []}
        for _ in range(TIMING_REPS):
            for name, fn in (("eager", lambda: predictor.kernel(
                                 torch.as_tensor(Xp, device=dev)).cpu().numpy()),
                             ("graph", lambda: predictor._predict_padded(Xp))):
                t0 = time.perf_counter()
                fn()
                times[name].append(1e3 * (time.perf_counter() - t0))
        out[b] = {"bit_equal_to_eager": bool(np.array_equal(replay, eager)),
                  "err_over_scale_vs_plain": rel,
                  "host_ms_eager": statistics.median(times["eager"]),
                  "host_ms_graph": statistics.median(times["graph"])}
        if not out[b]["bit_equal_to_eager"] or rel >= BARS[engine]:
            raise RuntimeError(f"{engine} bucket {b}: the graph replay disagrees with the "
                               f"eager kernel or the plain version (bar {BARS[engine]}): "
                               f"{out[b]}")
    return out


def _serve_graph(torch, dev, store) -> dict:
    """``serve-graph``: the checkpoint served on ``auto`` (-> ``kernel``),
    then on ``kernel-bf16`` and ``kernel-int8``, each from a cold cache:
    the captures equal the buckets at warm-up and stay 0 over the
    requests; every bucket's replay bit-equal to the eager kernel and
    within the engine's bar of the plain version."""
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import GRAPH_CACHE, serve_latest_model

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    # the singles pad to the 256-row bucket, the batches to 512 and 4096
    batches = [torch.rand(n, generator=gen, device=dev) * 100.0 for n in (300, 4096)]
    singles = [50.0, 10.0, 90.0]
    out = {}
    for requested, engine in (("auto", "kernel"), ("kernel-bf16", "kernel-bf16"),
                              ("kernel-int8", "kernel-int8")):
        GRAPH_CACHE.reset()
        reset_launches()
        handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                    engine=requested, device=dev)
        try:
            warm = GRAPH_CACHE.stats()
            health, checks = _check_served(torch, dev, handle, singles, batches)
            served = GRAPH_CACHE.stats()
            launches = dict(LAUNCHES)
            predictor = handle.app.predictor
            buckets = _bucket_checks(torch, dev, predictor, engine, seed=len(out))
        finally:
            handle.stop()
        line = {"requested": requested, "engine": health["engine"],
                "buckets": list(predictor.buckets), "captures_at_warmup": warm["captures"],
                "captures_over_requests": served["captures"] - warm["captures"],
                "replays_over_requests": served["replays"] - warm["replays"],
                "launches": launches, "per_bucket": buckets, "bar": BARS[engine], **checks}
        emit("serve-graph", **line)
        if health["engine"] != engine or warm["captures"] != len(predictor.buckets):
            raise RuntimeError(f"{engine}: {warm['captures']} captures at warm-up for "
                               f"{len(predictor.buckets)} buckets ({health['engine']})")
        if line["captures_over_requests"] or checks["worst_err_over_scale"] >= BARS[engine]:
            raise RuntimeError(f"{engine}: a request captured, or an answer is off: {line}")
        if launches[engine] < line["replays_over_requests"] + warm["replays"]:
            raise RuntimeError(f"{engine}: replays went uncounted: {line}")
        out[engine] = line
    return out


def _serve_graph_swap(torch, dev, store, second) -> dict:
    """``serve-graph-swap``: a second checkpoint of the same architecture
    served in the same process while the first still serves: no capture,
    one rebind; each service answers with its own weights (held against
    its own eager kernel, bit-equal), and the first again after the second."""
    import numpy as np

    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import GRAPH_CACHE, serve_latest_model, serve_model

    GRAPH_CACHE.reset()
    reset_launches()
    first = serve_latest_model(store, host="127.0.0.1", port=0, block=False, engine="auto",
                               device=dev)
    try:
        before = GRAPH_CACHE.stats()
        swap = serve_model(second, date(2026, 7, 4), host="127.0.0.1", port=0, block=False,
                           engine="auto")
        try:
            after_warm = GRAPH_CACHE.stats()
            xs = [float(x) for x in np.linspace(1, 99, 9)]
            got_second = [post(swap.url, {"X": x})["prediction"] for x in xs]
            got_first = [post(first.url, {"X": x})["prediction"] for x in xs]
            end = GRAPH_CACHE.stats()
            launches = dict(LAUNCHES)
            # each single row pads to the 256-row bucket, whose launch plan
            # fixes the kernel's summation order: the eager reference runs
            # the rows in one batch of that bucket
            bucket = first.app.predictor.buckets[0]
            X = torch.zeros(bucket, 1, device=dev)
            X[:len(xs), 0] = torch.tensor(xs, device=dev)
            eager = {name: [float(v) for v in h.app.predictor.kernel(X)[:len(xs)].cpu()]
                     for name, h in (("first", first), ("second", swap))}
        finally:
            swap.stop()
    finally:
        first.stop()
    out = {"captures_at_swap": after_warm["captures"] - before["captures"],
           "rebinds_at_swap": after_warm["rebinds"] - before["rebinds"],
           "misses_at_swap": after_warm["misses"] - before["misses"],
           "rebinds_serving_both_in_turn": end["rebinds"] - after_warm["rebinds"],
           "captures_total": end["captures"],
           "second_equals_its_eager": got_second == eager["second"],
           "first_equals_its_eager": got_first == eager["first"],
           "second_differs_from_first": all(a != b for a, b in zip(got_second, got_first)),
           "launches": launches, "requests": 2 * len(xs)}
    emit("serve-graph-swap", **out)
    if out["captures_at_swap"] or out["misses_at_swap"] or out["rebinds_at_swap"] != 1:
        raise RuntimeError(f"the same-architecture swap captured or did not rebind once: {out}")
    if not (out["second_equals_its_eager"] and out["first_equals_its_eager"]
            and out["second_differs_from_first"]):
        raise RuntimeError(f"a service answered with another checkpoint's weights: {out}")
    return out


def _serve_graph_overlap(torch, dev, store, hist) -> dict:
    """``serve-graph-overlap``: the kernel predictor's buckets captured on
    this thread while another thread runs OVERLAP_STEPS Adam steps of the
    1024-wide MLP on the card; both finish, the capture lies inside the
    training, its replays equal the eager kernel, and the losses equal an
    unshared run of the same steps bit for bit."""
    import threading

    import numpy as np

    from bodywork_tpu_torch.models import MLPConfig
    from bodywork_tpu_torch.models.base import pad_rows
    from bodywork_tpu_torch.models.mlp import (
        _scaled_splits,
        draw_indices,
        fit_keys,
        init_mlp_params,
        train_core,
    )
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import GRAPH_CACHE, build_predictor

    cfg = MLPConfig(**{**LOOP_MLP, "n_steps": OVERLAP_STEPS})
    X_hist, y_hist = hist
    Xp, yp, w = (torch.as_tensor(a, device=dev) for a in pad_rows(
        X_hist.cpu().numpy()[:, None], y_hist.cpu().numpy()))
    Xs, ys, _ = _scaled_splits(Xp, yp, w)
    k_init, k_train = fit_keys(13)
    idx = draw_indices(k_train, OVERLAP_STEPS, cfg.batch_size, Xp.shape[0], device=dev)

    def train(started=None) -> tuple:
        net = init_mlp_params(k_init, WIDTHS, device=dev)
        torch.cuda.synchronize()
        if started is not None:
            started.set()
        t0 = time.perf_counter()
        _, losses = train_core(net, Xs, ys, w, idx, cfg)
        torch.cuda.synchronize()
        return losses.cpu(), t0, time.perf_counter()

    alone = train()[0]
    box, started = {}, threading.Event()

    def worker():
        box["losses"], box["t0"], box["t1"] = train(started)

    from bodywork_tpu_torch.models.checkpoint import load_model

    model, _ = load_model(store, device=dev)
    predictor = build_predictor(model, "kernel")
    GRAPH_CACHE.reset()
    reset_launches()
    thread = threading.Thread(target=worker, name="overlap-train")
    thread.start()
    started.wait()
    time.sleep(0.02)  # the Adam loop is issuing its kernels
    t0 = time.perf_counter()
    predictor.warmup()
    t1 = time.perf_counter()
    thread.join()
    stats, launches = GRAPH_CACHE.stats(), dict(LAUNCHES)
    rng = np.random.default_rng(14)
    Xq = rng.uniform(0, 100, (predictor.buckets[0], 1)).astype(np.float32)
    replay_equal = bool(np.array_equal(
        predictor._predict_padded(Xq),
        predictor.kernel(torch.as_tensor(Xq, device=dev)).cpu().numpy()))
    shared = box["losses"]
    out = {"steps": OVERLAP_STEPS, "captures": stats["captures"],
           "capture_s": t1 - t0, "train_s": box["t1"] - box["t0"],
           "capture_inside_training": box["t0"] < t0 and t1 < box["t1"],
           "losses_equal_unshared": bool(torch.equal(shared, alone)),
           "max_abs_loss_gap": float((shared - alone).abs().max()),
           "final_loss": float(shared[-1]), "replay_bit_equal_to_eager": replay_equal,
           "launches": launches}
    emit("serve-graph-overlap", **out)
    if stats["captures"] != len(predictor.buckets) or not replay_equal:
        raise RuntimeError(f"the capture beside training failed: {out}")
    if not out["capture_inside_training"]:
        raise RuntimeError(f"the capture did not run beside the training: {out}")
    if not out["losses_equal_unshared"]:
        raise RuntimeError(f"training beside a capture drifted from an unshared run: {out}")
    return out


def _config7(handle, seq_x, client_x) -> dict:
    """Config 7's load on a started service: 20 untimed requests, then
    ``seq_x`` as sequential single rows on one keep-alive connection, then
    one closed-loop client per list of ``client_x``, each on its own
    connection after one untimed request. p50/p99 (nearest rank) of both
    parts, the concurrent part's requests/s, and the realised rows per
    dispatch (the part's requests, each client's untimed first one
    included, over the ``kernel`` launches in that part); ``answers`` holds
    every timed ``(status, headers, body, seconds)``, sequential first."""
    import threading

    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES

    conn = _connect(handle.base_url)
    for _ in range(20):
        _score(conn, 50.0)
    at_seq = LAUNCHES["kernel"]
    seq = [_score(conn, x) for x in seq_x]
    conn.close()
    at_conc = LAUNCHES["kernel"]
    conc = [[] for _ in client_x]
    start = threading.Barrier(len(client_x))

    def client(i):
        c = _connect(handle.base_url)
        _score(c, 50.0)
        start.wait()
        conc[i] = [_score(c, x) for x in client_x[i]]
        c.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(client_x))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    end = LAUNCHES["kernel"]
    seq_s = [s for _, _, _, s in seq]
    conc_s = [s for per in conc for _, _, _, s in per]
    return {
        "answers": seq + [a for per in conc for a in per],
        "sequential": {"requests": len(seq_s), "p50_ms": 1e3 * _nearest_rank(seq_s, 50),
                       "p99_ms": 1e3 * _nearest_rank(seq_s, 99),
                       "rows_per_dispatch": len(seq_s) / max(1, at_conc - at_seq)}
        if seq_s else None,
        "concurrent": {"clients": len(client_x), "requests": len(conc_s),
                       "p50_ms": 1e3 * _nearest_rank(conc_s, 50),
                       "p99_ms": 1e3 * _nearest_rank(conc_s, 99),
                       "requests_per_s": len(conc_s) / wall,
                       "rows_per_dispatch": (len(conc_s) + len(client_x))
                       / max(1, end - at_conc)},
    }


def _serve_coalesce(torch, dev, store) -> dict:
    """``serve-coalesce``: config 7's shape (``bench.py:646``) on both
    front ends, coalescer off (window 0) and on (2 ms, 64 rows): 20
    untimed requests, 300 sequential single rows on one keep-alive
    connection, then 16 closed-loop clients x 25, each on its own
    connection. p50/p99 (nearest rank) of both parts, realised rows per
    dispatch (the part's requests, each client's untimed first one
    included, over the kernel's launches in that part), and every answer
    byte-identical across the four services."""
    import numpy as np

    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import serve_latest_model

    rng = np.random.default_rng(7)
    seq_x = [round(float(x), 3) for x in rng.uniform(0, 100, COALESCE["sequential"])]
    client_x = [[round(float(x), 3) for x in rng.uniform(0, 100, COALESCE["per_client"])]
                for _ in range(COALESCE["clients"])]
    runs, bodies, launches_by_run = {}, {}, {}
    for engine in ("thread", "aio"):
        for window in COALESCE["windows"]:
            name = f"{engine}-window-{window:g}ms"
            reset_launches()
            handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                        engine="auto", device=dev, server_engine=engine,
                                        batch_window_ms=window,
                                        batch_max_rows=COALESCE["max_rows"])
            try:
                load = _config7(handle, seq_x, client_x)
                batcher = handle.app.batcher
                stats = batcher.stats() if batcher is not None else None
                launches_by_run[name] = dict(LAUNCHES)
            finally:
                handle.stop()
            if any(status != 200 for status, _, _, _ in load["answers"]):
                raise RuntimeError(f"{name}: a request failed")
            bodies[name] = [body for _, _, body, _ in load["answers"]]
            runs[name] = {
                "engine": engine, "window_ms": window, "max_rows": COALESCE["max_rows"],
                "sequential": load["sequential"], "concurrent": load["concurrent"],
                "coalescer": stats, "launches": launches_by_run[name],
            }
            emit("serve-coalesce", name=name, **runs[name])
    reference = bodies["thread-window-0ms"]
    identical = {name: b == reference for name, b in bodies.items()}
    emit("serve-coalesce-identity", requests=len(reference), identical_to_uncoalesced=identical)
    if not all(identical.values()):
        raise RuntimeError(f"coalesced or aio answers differ from the uncoalesced "
                           f"thread engine's: {identical}")
    return {"runs": runs, "launches": launches_by_run}


def _metrics_value(base_url: str, series: str) -> float:
    with urllib.request.urlopen(base_url + "/metrics", timeout=60) as resp:
        for line in resp.read().decode().splitlines():
            if line.startswith(series + " "):
                return float(line.rsplit(" ", 1)[1])
    return 0.0


def _serve_admission(torch, dev, store) -> dict:
    """``serve-admission``: the aio front end with ``max_pending`` 8 and
    the coalescer on, under a burst of 64 simultaneous single rows, each
    on its own connection: the 429s carry ``Retry-After``, every 200 is
    the answer the same row gets unshed, and the ``/metrics`` shed count
    rises by exactly the 429s."""
    import threading

    import numpy as np

    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import serve_latest_model

    xs = [round(float(x), 3) for x in
          np.random.default_rng(9).uniform(0, 100, ADMISSION["burst"])]
    series = 'bodywork_tpu_serve_shed_total{reason="admission"}'
    reset_launches()
    handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False, engine="auto",
                                device=dev, server_engine="aio", batch_window_ms=2.0,
                                max_pending=ADMISSION["max_pending"])
    try:
        conn = _connect(handle.base_url)
        unshed = {x: _score(conn, x)[2] for x in xs}
        conn.close()
        shed_before = _metrics_value(handle.base_url, series)
        conns = [_connect(handle.base_url) for _ in xs]
        for c in conns:
            c.connect()
        results = [None] * len(xs)
        start = threading.Barrier(len(xs))

        def one(i):
            start.wait()
            results[i] = _score(conns[i], xs[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for c in conns:
            c.close()
        shed_after = _metrics_value(handle.base_url, series)
        state = handle.app.admission.state()
        high_water = handle.app.admission.max_observed_pending
        launches = dict(LAUNCHES)
    finally:
        handle.stop()
    statuses = [r[0] for r in results]
    sheds = [r for r in results if r[0] == 429]
    out = {"max_pending": ADMISSION["max_pending"], "burst": len(xs),
           "ok": statuses.count(200), "shed_429": len(sheds),
           "other": len(xs) - statuses.count(200) - len(sheds),
           "retry_after_s": sorted({r[1].get("Retry-After") for r in sheds}),
           "metrics_shed_delta": shed_after - shed_before,
           "max_observed_pending": high_water,
           "every_200_equals_unshed": all(r[2] == unshed[x] for x, r in zip(xs, results)
                                          if r[0] == 200),
           "admission_state": state, "launches": launches}
    emit("serve-admission", **out)
    if not sheds or out["other"] or None in out["retry_after_s"] \
            or high_water > ADMISSION["max_pending"]:
        raise RuntimeError(f"the burst was not shed with 429 + Retry-After: {out}")
    if not out["every_200_equals_unshed"] or out["metrics_shed_delta"] != len(sheds):
        raise RuntimeError(f"admission answers or counts are off: {out}")
    return out


def phase_serving(torch, dev, workdir: str) -> dict:
    """The serving machinery on the card (see the module docstring)."""
    store, second, hist = _serving_models(torch, dev, workdir)
    graph = _serve_graph(torch, dev, store)
    swap = _serve_graph_swap(torch, dev, store, second)
    overlap = _serve_graph_overlap(torch, dev, store, hist)
    coalesce = _serve_coalesce(torch, dev, store)
    admission = _serve_admission(torch, dev, store)
    torch.cuda.synchronize()
    launches = {engine: graph[engine]["launches"][engine] for engine in graph}
    return {"graph": graph, "swap": swap, "overlap": overlap, "coalesce": coalesce,
            "admission": admission, "launches_by_path": {
                "serve-graph": launches,
                "serve-graph-swap": swap["launches"],
                "serve-graph-overlap": overlap["launches"],
                "serve-coalesce": {e: sum(r[e] for r in coalesce["launches"].values())
                                   for e in VARIANTS},
                "serve-admission": admission["launches"]}}


def _check_traces(name: str, traces: list, coalesced_singles: bool) -> dict:
    """Hold one service's recorded traces to the tracing contract: the
    JAX package's spans in its order (``queue-wait`` on a coalesced single
    row), every coalesced member linked to one shared dispatch span, and
    the graph cache's ``aot_cache``/``bucket`` on every direct dispatch."""
    # identical bodies mint identical ids (the determinism contract), so a
    # root span id may name several requests
    by_root: dict = {}
    for t in traces:
        by_root.setdefault(t["root_span_id"], []).append(
            [s for s in t["spans"] if s["name"] == "device-dispatch"])
    shared = 0
    for t in traces:
        names = [s["name"] for s in t["spans"]]
        single = t["route"] == "/score/v1"
        want = (["parse", "queue-wait", "device-dispatch", "serialize"]
                if single and coalesced_singles else ["parse", "device-dispatch", "serialize"])
        if names != want or t["status"] != 200:
            raise RuntimeError(f"{name}: trace {t['trace_id']} spans {names} != {want}")
        dispatch = t["spans"][names.index("device-dispatch")]
        meta = dispatch["meta"]
        if meta.get("coalesced"):
            if t["root_span_id"] not in meta["links"] or len(meta["links"]) != meta["batch_rows"]:
                raise RuntimeError(f"{name}: a coalesced member's links are off: {meta}")
            for root in meta["links"]:
                if not any(o and o[0]["meta"] == meta
                           and o[0]["duration_s"] == dispatch["duration_s"]
                           for o in by_root.get(root, ())):
                    raise RuntimeError(f"{name}: linked member {root} does not hold the "
                                       f"shared dispatch span")
            shared += len(meta["links"]) > 1
        elif meta.get("aot_cache") not in ("warm", "hit", "miss") or "bucket" not in meta:
            raise RuntimeError(f"{name}: a direct dispatch span lacks aot_cache/bucket: {meta}")
    return {"traces": len(traces), "dispatches_shared_by_several": shared,
            "aot_cache": sorted({s["meta"].get("aot_cache", "-") for t in traces
                                 for s in t["spans"] if s["name"] == "device-dispatch"})}


def _span_breakdown(traces: list) -> dict:
    """Median ms of each span of single-row traces, and of the remainder
    (the trace's duration outside its spans: routing, the firewall, the
    coalescer's hand-off back)."""
    per: dict = {"parse": [], "queue-wait": [], "device-dispatch": [], "serialize": [],
                 "remainder": [], "trace": []}
    for t in traces:
        spans = {s["name"]: s["duration_s"] for s in t["spans"]}
        for key in ("parse", "queue-wait", "device-dispatch", "serialize"):
            if key in spans:
                per[key].append(spans[key])
        per["remainder"].append(t["duration_s"] - sum(spans.values()))
        per["trace"].append(t["duration_s"])
    return {k: 1e3 * statistics.median(v) for k, v in per.items() if v}


def phase_trace(torch, dev, workdir: str) -> dict:
    """``trace``: the 1024-wide MLP served on ``auto`` (-> ``kernel``) on
    the ``thread`` and ``aio`` front ends, coalescer off and on (2 ms, 64
    rows), at trace fraction 1.0: single rows one after another, one with
    an ingress ``traceparent``, one 4096-row batch, then 16 clients x 25
    single rows. Every response carries its 32-hex id in a header and in
    no body, the ingress id is kept, every trace holds the JAX package's
    spans (:func:`_check_traces`), the ``/healthz`` exemplars resolve to
    recorded traces, and the span breakdown of the 16 clients' requests
    is printed. Then ``trace-overhead``: config 7 on the ``thread`` front
    end, coalescer off, at fractions 0, 0.1, 1.0, 1.0, 0.1, 0."""
    import numpy as np

    from bodywork_tpu_torch.obs import registry, tracing
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import serve_latest_model

    store = _serving_models(torch, dev, workdir)[0]
    process_registry = registry.get_registry()
    rng = np.random.default_rng(13)
    singles = [round(float(x), 3) for x in rng.uniform(0, 100, TRACE["singles"])]
    batch = [round(float(x), 3) for x in rng.uniform(0, 100, TRACE["batch_rows"])]
    client_x = [[round(float(x), 3) for x in rng.uniform(0, 100, COALESCE["per_client"])]
                for _ in range(COALESCE["clients"])]
    tracer = tracing.get_tracer()
    previous = (tracer.sample_fraction, tracer.seed)

    def serve(engine, window):
        return serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                  engine="auto", device=dev, server_engine=engine,
                                  batch_window_ms=window, batch_max_rows=COALESCE["max_rows"])

    runs = {}
    reset_launches()
    try:
        # room for every trace of a run: the exemplars must resolve
        tracing.configure_tracing(1.0, seed=0, recorder_capacity=4096)
        for engine in ("thread", "aio"):
            for window in COALESCE["windows"]:
                name = f"{engine}-window-{window:g}ms"
                tracer.recorder.clear()
                # a metrics registry of the service's own: the process's
                # latency histogram holds earlier phases' exemplars
                registry._DEFAULT = registry.Registry()
                handle = serve(engine, window)
                try:
                    conn = _connect(handle.base_url)
                    answers = [_post_json(conn, "/score/v1", {"X": x}) for x in singles]
                    ingress = _post_json(conn, "/score/v1", {"X": 50.0},
                                         {"traceparent": TRACE["ingress"]})
                    answers.append(_post_json(conn, "/score/v1/batch", {"X": batch}))
                    conn.close()
                    n_before = len(tracer.recorder)
                    load = _config7(handle, [], client_x)
                    health = get(handle.base_url + "/healthz")
                finally:
                    handle.stop()
                traces = tracer.recorder.snapshot()
                header = "X-Bodywork-Trace-Id"
                for status, headers, sent, body, _s in answers:
                    trace_id = headers.get(header, "")
                    if (status != 200 or trace_id != tracing.mint_trace_id(0, sent)
                            or trace_id.encode() in body):
                        raise RuntimeError(f"{name}: a response's trace id is off: "
                                           f"{status} {trace_id!r}")
                load_ids = [h.get(header) for _st, h, _b, _s in load["answers"]]
                if not all(i and len(i) == 32 for i in load_ids):
                    raise RuntimeError(f"{name}: a concurrent response lacks its trace id")
                by_id = {t["trace_id"]: t for t in traces}
                kept = ingress[1].get(header) == TRACE["ingress"][3:35]
                ingress_doc = by_id.get(TRACE["ingress"][3:35], {})
                exemplars = health["latency_exemplars"] or {}
                checks = _check_traces(name, traces, coalesced_singles=window > 0)
                runs[name] = {
                    "engine": engine, "window_ms": window, "requests": len(answers) + 1
                    + len(load["answers"]) + len(client_x) + 20, **checks,
                    "ingress_id_kept": kept,
                    "ingress_parent_span_id": ingress_doc.get("parent_span_id"),
                    "exemplars": len(exemplars),
                    "exemplars_resolve": bool(exemplars) and set(exemplars.values()) <= set(by_id),
                    "client_ms_16_clients": {"p50": load["concurrent"]["p50_ms"],
                                             "p99": load["concurrent"]["p99_ms"]},
                    "span_ms_16_clients_median": _span_breakdown(
                        [t for t in traces[n_before:] if t["route"] == "/score/v1"]),
                }
                emit("trace", name=name, **runs[name])
                if (checks["traces"] != runs[name]["requests"] or not kept
                        or ingress_doc.get("parent_span_id") != TRACE["ingress"][36:52]
                        or not runs[name]["exemplars_resolve"]
                        or (window > 0 and not checks["dispatches_shared_by_several"])):
                    raise RuntimeError(f"{name}: the traces break the contract: {runs[name]}")
        registry._DEFAULT = process_registry
        launches = dict(LAUNCHES)
        if launches["kernel"] < 1:
            raise RuntimeError(f"the traced services launched no kernel: {launches}")
        overhead = {}
        seq_x = [round(float(x), 3) for x in rng.uniform(0, 100, COALESCE["sequential"])]
        for i, fraction in enumerate(TRACE["fractions"]):
            tracing.configure_tracing(fraction, seed=0, recorder_capacity=4096)
            handle = serve("thread", 0)
            try:
                load = _config7(handle, seq_x, client_x)
            finally:
                handle.stop()
            if any(a[0] != 200 for a in load["answers"]):
                raise RuntimeError(f"trace-overhead: a request failed at {fraction}")
            overhead[f"{i}:{fraction:g}"] = row = {
                "fraction": fraction, "window_ms": 0, "turn": i,
                "sequential_p50_ms": load["sequential"]["p50_ms"],
                "sequential_p99_ms": load["sequential"]["p99_ms"],
                "requests_per_s_16_clients": load["concurrent"]["requests_per_s"],
                "p99_ms_16_clients": load["concurrent"]["p99_ms"],
                "traces_recorded": len(tracer.recorder),
            }
            emit("trace-overhead", engine="thread", **row)
    finally:
        registry._DEFAULT = process_registry
        tracing.configure_tracing(*previous, recorder_capacity=tracing.DEFAULT_RECORDER_CAPACITY)
    return {"runs": runs, "overhead": overhead, "launches": launches,
            "launches_all": dict(LAUNCHES)}


# -- open-loop traffic, hot reload, the canary loop, A/B pipelines ------------

def _body_transport(base_url: str, kind: str, sink: dict, n_requests: int):
    """An open-loop transport (``traffic.runner``'s pool and framing) that
    keeps each answer: ``sink[(t_s, route, x)] = (status, model key,
    body)``, and closes its pool on the loop when the last of
    ``n_requests`` ends."""
    from urllib.parse import urlsplit

    from bodywork_tpu_torch.serve.wire import BINARY_CONTENT_TYPE
    from bodywork_tpu_torch.traffic.runner import _ConnectionPool

    parts = urlsplit(base_url)
    pool = _ConnectionPool(parts.hostname, parts.port)
    ctype = BINARY_CONTENT_TYPE if kind == "binary" else "application/json"
    ended = [0]

    async def transport(req):
        body = req.payload_binary() if kind == "binary" else req.payload()
        head = (f"POST {req.route} HTTP/1.1\r\nHost: {pool.host}:{pool.port}\r\n"
                f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n\r\n"
                ).encode("latin-1")
        reader, writer, _reused = await pool.acquire()
        reusable = False
        try:
            writer.write(head + body)
            await writer.drain()
            status = int((await reader.readline()).split(b" ", 2)[1])
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _sep, value = line.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
            payload = await reader.readexactly(int(headers.get("content-length", 0)))
            key = headers.get("x-bodywork-model-key")
            sink[(req.t_s, req.route, req.x)] = (status, key, payload)
            reusable = headers.get("connection", "").lower() != "close"
            retry = headers.get("retry-after")
            return status, float(retry) if retry else None, key, headers.get(
                "x-bodywork-trace-id")
        finally:
            pool.release(reader, writer, reusable)
            ended[0] += 1
            if ended[0] == n_requests:
                pool.close()

    return transport


def _drive(base_url: str, log: list, kind: str = "json", results_log=None,
           shards: int = TRAFFIC["shards"], on_start=None) -> tuple:
    """A correctness drive: ``run_open_loop``'s one-loop drive of ``log``
    through :func:`_body_transport`, ``(report dict, answers)``.

    One event loop cannot send ~2000 requests/s on time, and parsing
    every answer slows it further: its late sends arrive in bunches that
    admission sheds. ``shards=N`` splits the log round-robin (``log[i::N]``,
    as ``run_open_loop``'s shards do) over N spawned processes, each
    running the one-loop drive of its slice; all start their clocks on
    one signal, and :func:`_merged_report` folds their per-request results
    into one report (the send-lag p99 from every request's lag), with each
    shard's own counts under ``by_shard``. ``shards=1`` drives in this
    process and writes each request's outcome to ``results_log`` where
    given. ``on_start`` is called just before the clocks start."""
    shards = min(shards, len(log))
    if shards == 1:
        from bodywork_tpu_torch.traffic import run_open_loop

        answers: dict = {}
        transport = _body_transport(base_url, kind, answers, len(log))
        if on_start is not None:
            on_start()
        report = run_open_loop(base_url, log, timeout_s=30.0, transport=transport,
                               results_log=results_log)
        return report.to_dict(), answers
    if results_log is not None:
        raise ValueError("a sharded drive writes no results log")
    import multiprocessing

    # spawn, not fork: this process holds threads and a CUDA context
    ctx = multiprocessing.get_context("spawn")
    procs, conns, outs = [], [], None
    try:
        for i in range(shards):
            conn, child = ctx.Pipe()
            proc = ctx.Process(target=_drive_shard, args=(base_url, log[i::shards], kind, child),
                               daemon=True)
            proc.start()
            child.close()
            procs.append(proc)
            conns.append(conn)
        for i, conn in enumerate(conns):
            _shard_message(conn, i, 300.0)  # ready: imports done, transport built
        if on_start is not None:
            on_start()
        for conn in conns:
            conn.send("go")
        deadline = 60.0 + 2 * max(r.t_s for r in log)
        outs = [_shard_message(conn, i, deadline) for i, conn in enumerate(conns)]
    finally:
        for proc in procs:
            proc.join(timeout=30 if outs is not None else 0)
            if proc.is_alive():
                proc.kill()
                proc.join()
    answers, results, timeouts, by_shard = {}, [], 0, []
    for i, (_tag, shard_results, shard_timeouts, shard_answers) in enumerate(outs):
        if answers.keys() & shard_answers.keys():
            raise RuntimeError(f"shard {i} answered a request another shard answered")
        answers.update(shard_answers)
        results.extend(shard_results)
        timeouts += shard_timeouts
        by_shard.append(_merged_report(shard_results, shard_timeouts, log[i::shards]))
    report = _merged_report(results, timeouts, log, shards)
    report["by_shard"] = [{k: r[k] for k in ("requests", "ok", "shed", "send_lag_p99_s")}
                          for r in by_shard]
    return report, answers


def _shard_message(conn, i: int, timeout_s: float) -> tuple:
    """The next message of shard ``i`` of a sharded :func:`_drive`;
    raises on a shard's error, death or silence past ``timeout_s``."""
    if not conn.poll(timeout_s):
        raise RuntimeError(f"drive shard {i} sent nothing in {timeout_s:.0f} s")
    try:
        message = conn.recv()
    except EOFError:
        raise RuntimeError(f"drive shard {i} died without a result") from None
    if message[0] == "error":
        raise RuntimeError(f"drive shard {i}: {message[1]}")
    return message


def _drive_shard(base_url: str, log: list, kind: str, conn) -> None:
    """One process of a sharded :func:`_drive`: the one-loop body drive
    of its slice, its clock started on the parent's signal; its
    per-request results, timeouts and answers go back over ``conn``."""
    try:
        from bodywork_tpu_torch.traffic.runner import _drive_once

        answers: dict = {}
        transport = _body_transport(base_url, kind, answers, len(log))
        conn.send(("ready",))
        conn.recv()
        results, timeouts, _peak = _drive_once(base_url, log, 30.0, transport, kind)
        conn.send(("ok", results, timeouts, answers))
    except BaseException as exc:  # noqa: BLE001 - sent to the parent
        conn.send(("error", repr(exc)))
    finally:
        conn.close()


def _merged_report(results: list, timeouts: int, log: list, shards: int = 1) -> dict:
    """``run_open_loop``'s report of ``log`` from its per-request
    ``results`` gathered from ``shards`` drives: counts summed, every
    percentile (latency, send lag, each answering model key's) over the
    requests together, the peak in flight from their send and end times."""
    from bodywork_tpu_torch.traffic.runner import (
        LoadReport,
        _max_blackout_s,
        _merged_max_in_flight,
        _percentile,
        _round6,
    )

    span = max(max(r.t_s for r in log), 1e-6)
    ok = [r for r in results if r.status == 200]

    def in_window(rs):
        return sum(1 for r in rs if r.t_s + r.latency_s <= span)

    def pct(values, q):
        return _round6(_percentile(sorted(values), q))

    def count(test):
        return sum(1 for r in results if test(r.status))

    per_model_key = {}
    for key in sorted({r.model_key or "unknown" for r in ok}):
        rs = [r for r in ok if (r.model_key or "unknown") == key]
        per_model_key[key] = {
            "ok": len(rs), "ok_in_window": in_window(rs), "goodput_rps": round(len(rs) / span, 3),
            "latency": {"p50_s": pct([r.latency_s for r in rs], 50),
                        "p99_s": pct([r.latency_s for r in rs], 99)}}
    retry = [r.retry_after_s for r in results if r.retry_after_s is not None]
    shed = count(lambda s: s == 429)
    return LoadReport(
        requests=len(results), duration_s=round(span, 6),
        offered_rps=round(len(results) / span, 3), ok=len(ok), ok_in_window=in_window(ok),
        shed=shed, unavailable=count(lambda s: s == 503),
        client_error=count(lambda s: 400 <= s < 500 and s != 429),
        server_error=count(lambda s: s >= 500 and s != 503),
        transport_errors=count(lambda s: s == 0) - timeouts, timeouts=timeouts,
        goodput_rps=round(len(ok) / span, 3), goodput_in_window_rps=round(in_window(ok) / span, 3),
        shed_fraction=round(shed / len(results), 6),
        latency={q: pct([r.latency_s for r in ok], p)
                 for q, p in (("p50_s", 50), ("p99_s", 99), ("p999_s", 99.9))},
        retry_after={"responses": len(retry),
                     "mean_s": _round6(sum(retry) / len(retry)) if retry else None,
                     "max_s": _round6(max(retry)) if retry else None},
        send_lag_p99_s=pct([r.send_lag_s for r in results], 99),
        max_in_flight=_merged_max_in_flight(results), max_blackout_s=_max_blackout_s(results),
        traced_responses=sum(1 for r in results if r.trace_id is not None),
        per_model_key=per_model_key, shards=shards).to_dict()


def _measure(base_url: str, log: list, kind: str = "json") -> dict:
    """A load point's numbers: ``run_open_loop`` of ``log`` through the
    runner's own transport, sharded over ``TRAFFIC["shards"]`` spawned
    driver processes (one event loop cannot send ~2000 requests/s on
    time)."""
    from bodywork_tpu_torch.traffic import run_open_loop

    return run_open_loop(base_url, log, timeout_s=30.0, transport_kind=kind,
                         shards=TRAFFIC["shards"]).to_dict()


class _AdmissionWatch:
    """The service's admission block (``/healthz`` ``admission``) across
    a drive: ``shed_total`` and ``pending`` before and after it, and the
    highest ``queue_depth`` (what admission sheds on) and ``pending`` read
    every ``poll_s`` between, as ``line()``. The service keeps no
    high-water mark of its own that it reports, so the peaks are sampled."""

    def __init__(self, base_url: str, poll_s: float = 0.05):
        self.base_url, self.poll_s = base_url, poll_s

    def _state(self) -> dict:
        return get(self.base_url + "/healthz")["admission"]

    def __enter__(self):
        import threading

        self.before = self._state()
        self.peak = {k: self.before[k] for k in ("queue_depth", "pending")}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(self.poll_s):
            state = self._state()
            for k in self.peak:
                self.peak[k] = max(self.peak[k], state[k])

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.after = self._state()

    def line(self) -> dict:
        return {"shed_total": [self.before["shed_total"], self.after["shed_total"]],
                "pending": [self.before["pending"], self.after["pending"]],
                "peak_queue_depth_sampled": self.peak["queue_depth"],
                "peak_pending_sampled": self.peak["pending"],
                "max_pending": self.after["max_pending"]}


def _checked_line(report: dict, admission: _AdmissionWatch) -> dict:
    """A correctness drive's own numbers: its shards and their send lag,
    its counts and the service's admission across it."""
    return {"shards": report["shards"], "send_lag_p99_ms": 1e3 * (report["send_lag_p99_s"] or 0.0),
            "requests": report["requests"], "ok": report["ok"], "shed": report["shed"],
            "p99_ms": None if report["latency"]["p99_s"] is None
            else 1e3 * report["latency"]["p99_s"],
            "by_shard": report.get("by_shard"), "admission": admission.line()}


def _plain_check(torch, dev, layers: list, answers: dict) -> dict:
    """Every 200 single-row answer held against the kernel's plain version
    of ``layers`` on the card at the ``kernel`` bar."""
    from bodywork_tpu_torch.ops.mlp_kernel import mlp_stack_plain

    ok = [(k[2][0], json.loads(v[2])["prediction"]) for k, v in answers.items()
          if v[0] == 200]
    if not ok:
        raise RuntimeError("no request was answered 200")
    X = torch.tensor([[x] for x, _ in ok], dtype=torch.float32, device=dev)
    got = torch.tensor([p for _, p in ok], dtype=torch.float32, device=dev)
    err, rel = rel_err(got, mlp_stack_plain(layers, X, None))
    return {"answers_checked": len(ok), "max_abs_err": err, "err_over_scale": rel,
            "bar": BARS["kernel"]}


def _own_checkpoint_checks(torch, dev, layers: dict, answers: dict) -> tuple:
    """Each answer grouped by the checkpoint its ``X-Bodywork-Model-Key``
    names: ``(groups, checks, crossed)``, each group's 200s held against
    its own checkpoint's plain version (``checks``) and against every
    other checkpoint's in ``layers`` (``crossed``, the ``err_over_scale``
    that must miss the bar)."""
    groups = {}
    for k, v in answers.items():
        groups.setdefault(v[1], {})[k] = v
    checks = {key: _plain_check(torch, dev, layers[key], got)
              for key, got in groups.items() if key in layers}
    crossed = {f"{key} vs {other}": _plain_check(torch, dev, layers[other], got)[
                   "err_over_scale"]
               for key, got in groups.items() for other in layers
               if key in layers and other != key}
    return groups, checks, crossed


def _own_checkpoint_failed(checks: dict, crossed: dict) -> bool:
    """Whether an answer group missed its own checkpoint's plain version
    or came within the bar of another's (a NaN misses both)."""
    return (any(not c["err_over_scale"] < BARS["kernel"] for c in checks.values())
            or any(e < BARS["kernel"] for e in crossed.values()))


def _capacity(base_url: str, clients: int, seconds: float) -> float:
    """Closed-loop capacity: ``clients`` keep-alive clients sending single
    rows back to back for ``seconds``; 200s a second."""
    import threading

    import numpy as np

    counts = [0] * clients
    for x in np.linspace(1, 99, 20):  # untimed
        post(base_url + "/score/v1", {"X": float(x)})
    stop = time.perf_counter() + seconds

    def client(i):
        conn = _connect(base_url)
        rng = np.random.default_rng(100 + i)
        while time.perf_counter() < stop:
            counts[i] += _score(conn, round(float(rng.uniform(0, 100)), 3))[0] == 200
        conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(counts) / (time.perf_counter() - t0)


def _load_line(report: dict) -> dict:
    return {"offered_rps": report["offered_rps"], "goodput_rps": report["goodput_rps"],
            "goodput_in_window_rps": report["goodput_in_window_rps"],
            "p50_ms": None if report["latency"]["p50_s"] is None
            else 1e3 * report["latency"]["p50_s"],
            "p99_ms": None if report["latency"]["p99_s"] is None
            else 1e3 * report["latency"]["p99_s"],
            "shed_fraction": report["shed_fraction"], "requests": report["requests"],
            "ok": report["ok"], "send_lag_p99_ms": 1e3 * (report["send_lag_p99_s"] or 0.0),
            "max_in_flight": report["max_in_flight"], "shards": report["shards"]}


class _ServeProcess:
    """``cli serve`` of a store in a process of its own (config 9's
    isolated target: the driver here shares no interpreter lock with the
    service) on ``aio`` with the coalescer at 2 ms / 64 rows. ``stop``
    sends SIGTERM and requires exit 143 without an abort; the service's
    kernel launches and graph-cache counts come from its ``/healthz``
    (counted from the process's start)."""

    def __init__(self, store_root: str, reload_interval: float = 0.0, args=None,
                 env: dict | None = None):
        import queue
        import threading

        if args is None:  # config 9's coalescer
            args = ["--batch-window-ms", str(TRAFFIC["window_ms"]),
                    "--batch-max-rows", str(TRAFFIC["max_rows"])]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "bodywork_tpu_torch.cli", "serve", "--store", store_root,
             "--host", "127.0.0.1", "--port", "0", "--server-engine", "aio", *args,
             "--reload-interval", str(reload_interval)],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT, **(env or {})},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines: list = []
        self._queue: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [self._queue.put(line) for line in self.proc.stdout],
                         daemon=True).start()
        self.base_url = None
        deadline = time.monotonic() + 300
        while self.base_url is None and time.monotonic() < deadline and self.proc.poll() is None:
            try:
                line = self._queue.get(timeout=1)
            except queue.Empty:
                continue
            self.lines.append(line)
            if "listening on http://" in line:
                self.base_url = line.rsplit("listening on ", 1)[1].strip().replace(
                    "/score/v1", "")
        if self.base_url is None:
            self.proc.kill()
            raise RuntimeError("cli serve did not start: " + "".join(self.lines)[-3000:])

    def health(self) -> dict:
        return get(self.base_url + "/healthz")

    def wait_for_line(self, pattern: str, timeout_s: float):
        """The first output line from now on matching ``pattern`` (a
        regex), as its match; raises past ``timeout_s``."""
        import queue
        import re

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                line = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self.proc.poll() is not None:
                    break
                continue
            self.lines.append(line)
            match = re.search(pattern, line)
            if match:
                return match
        raise RuntimeError(f"no line matching {pattern!r} within {timeout_s} s: "
                           + "".join(self.lines)[-3000:])

    def stop(self) -> dict:
        """SIGTERM: exit 143 within 60 s, no abort in the output."""
        import signal

        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        time.sleep(0.2)  # the reader thread drains the pipe
        while not self._queue.empty():
            self.lines.append(self._queue.get())
        out = "".join(self.lines)
        result = {"rc": self.proc.returncode, "seconds": time.perf_counter() - t0,
                  "aborted": "Aborted" in out or "terminate called" in out}
        if result["rc"] != 143 or result["aborted"]:
            raise RuntimeError(f"cli serve did not leave on SIGTERM with 143: {result} "
                               + out[-3000:])
        return result


def phase_traffic(torch, dev, workdir: str) -> dict:
    """``traffic``: config 9's open-loop ramp (``bench.py:1771``) against
    ``cli serve`` in its own process on ``aio`` with the coalescer at 2 ms
    / 64 rows, the 1024-wide MLP on ``auto`` (-> ``kernel``): a closed-loop
    probe for capacity, then one seeded Poisson log at 0.5x, 1x and 2x of
    it (capped at 2000 requests/s), 3 s each, one MMPP log at 1x, and the
    1x log again, read back from its file, in the binary row framing.
    Each point is driven twice, both times by ``TRAFFIC["shards"]``
    spawned driver processes: once through the runner's own transport
    (:func:`_measure`, the printed numbers), once keeping every answer
    (:func:`_drive`, its own numbers under ``checked``), whose 200s are
    held against the plain version at the ``kernel`` bar, and whose
    binary answers must be byte-identical to the JSON ones; the log read
    back must be the same requests. Each point prints its real factor
    (offered over capacity) and the service's admission counters across
    each drive (:class:`_AdmissionWatch`); its sheds are recorded, not
    checked. The service's launches are read from its ``/healthz``;
    SIGTERM ends it with 143."""
    from bodywork_tpu_torch.models import load_model
    from bodywork_tpu_torch.ops.mlp_kernel import make_kernel_mlp_apply
    from bodywork_tpu_torch.traffic import (
        TrafficConfig,
        generate_request_log,
        read_request_log,
        write_request_log,
    )

    store = _serving_models(torch, dev, workdir)[0]
    model = load_model(store, device=dev)[0]
    layers = make_kernel_mlp_apply(model.params, dev).layers
    service = _ServeProcess(str(store.root))
    points = {}
    try:
        health = service.health()
        if health["engine"] != "kernel":
            raise RuntimeError(f"auto served the 1024-wide MLP through {health['engine']!r}")
        capacity = _capacity(service.base_url, TRAFFIC["probe_clients"], TRAFFIC["probe_s"])
        logs = {}
        for factor in TRAFFIC["factors"]:
            rate = min(capacity * factor, TRAFFIC["cap_rps"])
            logs[f"poisson-{factor:g}x"] = TrafficConfig(
                rate_rps=rate, duration_s=TRAFFIC["duration_s"], seed=TRAFFIC["seed"])
        logs["mmpp-1x"] = TrafficConfig(rate_rps=min(capacity, TRAFFIC["cap_rps"]),
                                        duration_s=TRAFFIC["duration_s"], arrival="mmpp",
                                        seed=TRAFFIC["seed"])
        answers = {}
        for name, config in logs.items():
            log = generate_request_log(config)
            with _AdmissionWatch(service.base_url) as measured:
                report = _measure(service.base_url, log)
            with _AdmissionWatch(service.base_url) as admission:
                checked, answers[name] = _drive(service.base_url, log)
            points[name] = {"factor": config.rate_rps / capacity,
                            "real_factor": report["offered_rps"] / capacity,
                            **_load_line(report), "admission": measured.line(),
                            "checked": _checked_line(checked, admission),
                            **_plain_check(torch, dev, layers, answers[name])}
            emit("traffic", name=name, transport="json", arrival=config.arrival,
                 capacity_rps=capacity, **points[name])
        # the 1x log: through a file and back, then in the binary framing
        path = os.path.join(workdir, "poisson-1x.jsonl")
        config = logs["poisson-1x"]
        log = generate_request_log(config)
        write_request_log(path, config, log)
        back_config, replay = read_request_log(path)
        with _AdmissionWatch(service.base_url) as measured:
            report = _measure(service.base_url, replay, kind="binary")
        with _AdmissionWatch(service.base_url) as admission:
            checked, binary = _drive(service.base_url, replay, kind="binary")
        points["poisson-1x-binary"] = {"factor": config.rate_rps / capacity,
                                       "real_factor": report["offered_rps"] / capacity,
                                       **_load_line(report), "admission": measured.line(),
                                       "checked": _checked_line(checked, admission),
                                       **_plain_check(torch, dev, layers, binary)}
        both = set(binary) & set(answers["poisson-1x"])
        same = [k for k in both if binary[k][0] == answers["poisson-1x"][k][0] == 200]
        differ = [k for k in same if binary[k][2] != answers["poisson-1x"][k][2]]
        replay_equal = back_config == config and replay == log
        emit("traffic", name="poisson-1x-binary", transport="binary",
             replay_equals_log=replay_equal, compared_with_json=len(same),
             differ_from_json=len(differ), **points["poisson-1x-binary"])
        health = service.health()
    finally:
        stopped = service.stop()
    # the service serves the f32 kernel alone: its /healthz counts that kernel's launches
    launches = {**dict.fromkeys(VARIANTS, 0), "kernel": health["launches"]}
    failed = [n for n, p in points.items() if p["err_over_scale"] >= BARS["kernel"]]
    if failed or differ or not replay_equal or not same or launches["kernel"] < 1:
        raise RuntimeError(f"traffic: plain-version misses {failed}, json/binary differ "
                           f"{len(differ)} of {len(same)}, replay equal {replay_equal}, "
                           f"launches {launches}")
    return {"capacity_rps": capacity, "points": points, "launches": launches,
            "graph_cache": health["graph_cache"], "sigterm": stopped}


def phase_reload(torch, dev, workdir: str, capacity_rps: float | None) -> dict:
    """``reload``: config 11's swap (``bench.py:1983``): ``cli serve
    --reload-interval`` in its own process (``aio``, coalescer 2 ms / 64
    rows) serving the registry's ``production``, the 1024-wide MLP, under
    an open-loop Poisson drive at 0.5x capacity, sent by
    ``TRAFFIC["shards"]`` driver processes (:func:`_drive`), while the
    registry promotes a second checkpoint of the same architecture. The
    drive's send-lag p99 must stay within ``RELOAD["max_send_lag_ms"]``
    (past it the driver, not the service, fails the phase); then no graph
    capture or build across the drive, at least one rebind (the service's
    ``/healthz`` ``graph_cache``), every answer's model key and value its
    own checkpoint's (held against each checkpoint's plain version at the
    ``kernel`` bar, and missing the other's), the p99 of each answering
    checkpoint printed. Then ``cli registry rollback`` on the store must
    reach the running service within two polls (``/healthz``
    ``model_key``), and SIGTERM ends it with 143."""
    import threading

    from bodywork_tpu_torch.models import save_model
    from bodywork_tpu_torch.ops.mlp_kernel import make_kernel_mlp_apply
    from bodywork_tpu_torch.registry import ModelRegistry, register_candidate
    from bodywork_tpu_torch.traffic import TrafficConfig, generate_request_log

    store, second, _hist = _serving_models(torch, dev, workdir)
    first_key = store.history("models/")[-1][0]
    register_candidate(store, first_key, day=date(2026, 7, 3))
    ModelRegistry(store).promote(first_key, day=date(2026, 7, 3))
    second_key = save_model(store, second, date(2026, 7, 4))
    register_candidate(store, second_key, day=date(2026, 7, 4))
    from bodywork_tpu_torch.models import load_model

    layers = {key: make_kernel_mlp_apply(load_model(store, key, device=dev)[0].params,
                                         dev).layers for key in (first_key, second_key)}
    service = _ServeProcess(str(store.root), reload_interval=RELOAD["poll_s"])
    try:
        if capacity_rps is None:
            capacity_rps = _capacity(service.base_url, TRAFFIC["probe_clients"],
                                     TRAFFIC["probe_s"])
        rate = min(RELOAD["factor"] * capacity_rps, TRAFFIC["cap_rps"])
        log = generate_request_log(TrafficConfig(rate_rps=rate, duration_s=RELOAD["duration_s"],
                                                 seed=TRAFFIC["seed"] + 1))
        before = service.health()["graph_cache"]
        promote = threading.Timer(RELOAD["swap_at_s"], lambda: ModelRegistry(store).promote(
            second_key, day=date(2026, 7, 4), reason="chip_smoke: live swap"))
        with _AdmissionWatch(service.base_url) as admission:
            report, answers = _drive(service.base_url, log, on_start=promote.start)
        promote.join()
        health = service.health()
        after = health["graph_cache"]
        by_key, checks, crossed = _own_checkpoint_checks(torch, dev, layers, answers)
        rollback = _cli(["registry", "rollback", "--store", str(store.root)])
        t0 = time.perf_counter()
        reached = None
        while time.perf_counter() - t0 < 10 * RELOAD["poll_s"]:
            if service.health()["model_key"] == first_key:
                reached = time.perf_counter() - t0
                break
            time.sleep(0.01)
        launches = {**dict.fromkeys(VARIANTS, 0), "kernel": service.health()["launches"]}
    finally:
        stopped = service.stop()
    out = {"rate_rps": rate, "real_factor": report["offered_rps"] / capacity_rps,
           **_load_line(report), "by_shard": report["by_shard"],
           "admission": admission.line(), "answering_keys": sorted(
               k or "none" for k in by_key),
           "captures_across_drive": after["captures"] - before["captures"],
           "misses_across_drive": after["misses"] - before["misses"],
           "rebinds_across_drive": after["rebinds"] - before["rebinds"],
           "p99_ms_by_checkpoint": {k: 1e3 * (v["latency"]["p99_s"] or 0.0)
                                    for k, v in report["per_model_key"].items()},
           "checks": checks, "err_over_scale_vs_other_checkpoint": crossed,
           "served_after_drive": health["model_key"], "rollback_rc": rollback["rc"],
           "rollback_cli_s": rollback["seconds"], "rollback_reached_s": reached,
           "poll_s": RELOAD["poll_s"], "launches": launches, "sigterm": stopped}
    emit("reload", **out)
    if out["send_lag_p99_ms"] > RELOAD["max_send_lag_ms"]:
        raise RuntimeError(f"reload: the DRIVER sent late, not the service: send-lag p99 "
                           f"{out['send_lag_p99_ms']:.1f} ms > {RELOAD['max_send_lag_ms']} ms, "
                           f"so its sheds and latencies do not measure the service: {out}")
    if (out["captures_across_drive"] or out["misses_across_drive"]
            or out["rebinds_across_drive"] < 1 or set(by_key) != {first_key, second_key}
            or _own_checkpoint_failed(checks, crossed)
            or report["ok"] != report["requests"] or health["model_key"] != second_key):
        raise RuntimeError(f"reload: the live swap broke its contract: {out}")
    if launches["kernel"] < 1:
        raise RuntimeError(f"reload: the service launched no kernel: {out}")
    if rollback["rc"] != 0 or reached is None or reached > 2 * RELOAD["poll_s"]:
        raise RuntimeError(f"reload: the rollback did not reach the service within two "
                           f"polls: {out} {rollback['err'][-2000:]}")
    return out


def phase_canary(torch, dev, workdir: str) -> dict:
    """``canary``: ``run_canary_chaos`` on the card for ``nan``,
    ``latency`` and ``healthy``, the two checkpoints 1024-wide MLPs
    (the loop's training settings at 200 Adam steps) served on ``auto``
    (-> ``kernel``):
    the watchdog's verdicts must be abort, abort and promote, production
    byte-identical to its canary-free twin, each verdict's flight record
    must open with ``cli trace show`` (exit 0). Every 200 of the
    canary'd app, production's and the canary's alike, is held against
    the plain version of the checkpoint its ``X-Bodywork-Model-Key``
    names at the ``kernel`` bar, and must miss the other checkpoint's:
    answers from the other stream's weights fail here. The canary must
    serve from the weight-slot lane beside production's, with no rebind,
    capture or build during the drive (with one shared slot every canary
    request rebound it, which slowed them). Printed: the rebinds per 1000
    requests, the verdict's window, each stream's request times (the six
    slowest with their index), the load average and this process's live
    descendants as the drive ended (``beside_verdict``: what ran beside an
    abort), and the interpreter's collections during the drive:
    at sub-millisecond requests the watchdog's p99 of a few dozen samples
    is their slowest, and a full collection of the heap the earlier
    phases left, landing in one canary request, decides it; so
    ``run_canary_chaos`` collects and freezes that heap before its drive."""
    import gc

    from bodywork_tpu_torch.chaos import canary as canary_module
    from bodywork_tpu_torch.chaos import run_canary_chaos
    from bodywork_tpu_torch.models import load_model
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, make_kernel_mlp_apply, reset_launches
    from bodywork_tpu_torch.serve import GRAPH_CACHE
    from bodywork_tpu_torch.store import FilesystemStore

    # the harness's per-request trace (bodies, model keys, statuses), kept
    drives = []
    drive = canary_module._drive

    def recorded(app, twin_app, watcher, xs, *args):
        seconds, handle = [], app.handle

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return handle(*a, **k)
            finally:
                seconds.append(time.perf_counter() - t0)

        app.handle = timed
        lanes = {"production": app.predictor.slot_lane,
                 "canary": app._canary.predictor.slot_lane if app._canary else None}
        # the interpreter's collections inside the drive, each with its ms
        pauses, started = [], [0.0]

        def collected(stage, info):
            if stage == "start":
                started[0] = time.perf_counter()
            else:
                pauses.append((info["generation"], 1e3 * (time.perf_counter() - started[0])))

        before = GRAPH_CACHE.stats()
        gc.callbacks.append(collected)
        try:
            trace = drive(app, twin_app, watcher, xs, *args)
        finally:
            gc.callbacks.remove(collected)
        # what ran beside the drive as its verdict fell
        beside = {"loadavg": _loadavg(), "processes": _descendants()}
        after = GRAPH_CACHE.stats()
        drives.append((xs, trace, seconds, lanes,
                       {k: after[k] - before[k] for k in ("rebinds", "captures", "misses")},
                       {"count": len(pauses), "gen2": sum(g == 2 for g, _ in pauses),
                        "max_ms": max((ms for _g, ms in pauses), default=0.0)}, beside))
        return trace

    out = {}
    reset_launches()
    canary_module._drive = recorded
    try:
        runs, collections = {}, {}
        for scenario in ("nan", "latency", "healthy"):
            root = os.path.join(workdir, f"canary-{scenario}")
            before = GRAPH_CACHE.stats()
            t0 = time.perf_counter()
            summary = run_canary_chaos(
                FilesystemStore(root), scenario=scenario, seed=0,
                n_requests=CANARY["requests"], fraction=CANARY["fraction"],
                model_type="mlp", model_kwargs=SOAK_MLP, device=dev)
            runs[scenario] = (root, summary, drives[-1], time.perf_counter() - t0,
                              before, GRAPH_CACHE.stats())
            collections[scenario] = drives[-1][5]
    finally:
        canary_module._drive = drive
    launches = dict(LAUNCHES)
    for scenario, (root, summary, (xs, trace, handled, lanes, in_drive, _gc, beside), seconds,
                   before, after) in runs.items():
        store = FilesystemStore(root)
        keys = (summary["production_key"], summary["canary_key"])
        layers = {key: make_kernel_mlp_apply(load_model(store, key, device=dev)[0].params,
                                             dev).layers for key in keys}
        answers = {(i, "/score/v1", (float(x),)): (status, key, body) for i, (x, status, key, body)
                   in enumerate(zip(xs, trace["statuses"], trace["keys"], trace["bodies"]))}
        groups, checks, crossed = _own_checkpoint_checks(torch, dev, layers, answers)
        # each stream's in-process request times, the slowest with their index
        request_ms = {}
        for i, (key, s) in enumerate(zip(trace["keys"], handled)):
            request_ms.setdefault("production" if key == keys[0] else "canary", []).append(
                (1e3 * s, i))
        request_ms = {stream: {"n": len(v), "median": statistics.median(ms for ms, _i in v),
                               "slowest": sorted(v, reverse=True)[:6]}
                      for stream, v in request_ms.items()}
        dump = summary["flight_record_keys"][-1] if summary["flight_record_keys"] else None
        shown = None
        if dump is not None:
            doc = json.loads(FilesystemStore(root).get_bytes(dump))
            shown = _cli(["trace", "show", doc["traces"][0]["trace_id"], "--store", root])
        # the canary'd app and its twin each answered every request
        served = 2 * summary["n_requests"]
        out[scenario] = row = {
            "ok": summary["ok"], "aborted": summary["aborted"],
            "promoted": summary["promoted"], "abort_at_request": summary["abort_at_request"],
            "promote_at_request": summary["promote_at_request"],
            "alias_cas_writes": summary["alias_cas_writes"],
            "violating_responses_serialized": summary["violating_responses_serialized"],
            "production_responses_compared": summary["production_responses_compared"],
            "production_responses_mismatched": summary["production_responses_mismatched"],
            "fallback_span_traces": summary["fallback_span_traces"],
            "answers_by_checkpoint": {("production" if k == keys[0] else "canary"): len(v)
                                      for k, v in groups.items() if k in layers},
            "plain_checks": {("production" if k == keys[0] else "canary"): c
                             for k, c in checks.items()},
            "err_over_scale_vs_other_checkpoint": crossed,
            "flight_record": dump, "trace_show_rc": shown["rc"] if shown else None,
            "verdict_window": doc.get("window") if dump is not None else None,
            "request_ms": request_ms, "collections": collections[scenario],
            "beside_verdict": beside,
            "slot_lanes": lanes, "graph_cache_in_drive": in_drive,
            # what made canary requests slow before the repair: every one
            # rebound the shared weight slot (the twin's production request
            # sat between any two); a live canary now has its own lane
            "slow_source": "shared weight slot: a rebind on every canary request "
                           "(repaired: the canary's own slot lane)",
            "rebinds": after["rebinds"] - before["rebinds"],
            "captures": after["captures"] - before["captures"],
            "rebinds_per_1000_requests": 1e3 * (after["rebinds"] - before["rebinds"]) / served,
            "requests_served": served, "seconds": seconds}
        emit("canary", scenario=scenario, **row)
        want = (False, True) if scenario == "healthy" else (True, False)
        if (not summary["ok"] or (summary["aborted"], summary["promoted"]) != want
                or summary["production_responses_mismatched"] or shown is None
                or shown["rc"] != 0 or set(groups) - set(layers)
                or lanes["production"] == lanes["canary"] or any(in_drive.values())
                or _own_checkpoint_failed(checks, crossed)):
            raise RuntimeError(f"canary {scenario}: {row} {summary}")
    if launches["kernel"] < 1:
        raise RuntimeError(f"the canary scenarios launched no kernel: {launches}")
    return {"scenarios": out, "launches": launches}


def _profile_logs(duration_s: float) -> dict:
    """Config 13's two row-shape profiles (``bench.py:3064-3100``):
    ``uniform_row`` (Poisson single rows at 150/s, seed 131) and
    ``heavy_tail_row`` (single rows at 30/s, seed 132, merged by arrival
    with 700-row batches at 10/s, seed 133), ``duration_s`` each:
    name -> (config, requests)."""
    from bodywork_tpu_torch.traffic import TrafficConfig, generate_request_log

    uniform = TrafficConfig(rate_rps=TUNE["uniform_rps"], duration_s=duration_s, seed=131)
    singles = TrafficConfig(rate_rps=0.75 * TUNE["heavy_rps"], duration_s=duration_s, seed=132)
    batches = TrafficConfig(rate_rps=0.25 * TUNE["heavy_rps"], duration_s=duration_s, seed=133,
                            batch_fraction=1.0, batch_rows=TUNE["heavy_rows"])
    heavy = sorted([*generate_request_log(singles), *generate_request_log(batches)],
                   key=lambda r: r.t_s)
    return {"uniform_row": (uniform, generate_request_log(uniform)),
            "heavy_tail_row": (singles, heavy)}


def _logged_drive(base_url: str, config, requests, workdir: str, name: str) -> tuple:
    """One profile's drive keeping every answer, with its request log and
    results log written as ``traffic run --log-out/--results-out`` write
    them: ``(report dict, answers, log path, results path)``."""
    from bodywork_tpu_torch.traffic import run_open_loop, write_request_log

    log_path = os.path.join(workdir, f"{name}.requests.jsonl")
    results_path = os.path.join(workdir, f"{name}.results.jsonl")
    write_request_log(log_path, config, requests)
    answers: dict = {}
    report = run_open_loop(base_url, requests, timeout_s=30.0, results_log=results_path,
                           transport=_body_transport(base_url, "json", answers, len(requests)))
    return report.to_dict(), answers, log_path, results_path


def _rows_check(torch, dev, layers: list, answers: dict) -> dict:
    """Every 200, single row or batch, held against the kernel's plain
    version of ``layers`` on the card at the ``kernel`` bar."""
    from bodywork_tpu_torch.ops.mlp_kernel import mlp_stack_plain

    xs, got = [], []
    for (_t, route, x), (status, _key, body) in answers.items():
        if status != 200:
            continue
        doc = json.loads(body)
        if route.endswith("/batch"):
            xs.extend(x)
            got.extend(doc["predictions"])
        else:
            xs.append(x[0])
            got.append(doc["prediction"])
    if not xs:
        raise RuntimeError("no request was answered 200")
    X = torch.tensor([[v] for v in xs], dtype=torch.float32, device=dev)
    err, rel = rel_err(torch.tensor(got, dtype=torch.float32, device=dev),
                       mlp_stack_plain(layers, X, None))
    return {"rows_checked": len(xs), "max_abs_err": err, "err_over_scale": rel,
            "bar": BARS["kernel"]}


def _effective_mismatch(knobs: dict, effective: dict) -> dict:
    """Each tuned knob whose live value (``/healthz`` ``effective_config``)
    differs from the document's: a window of 0 is coalescing off, so no
    coalescer runs and its two knobs read null."""
    want = {k: list(v) if isinstance(v, tuple) else v for k, v in knobs.items()}
    if want.get("batch_window_ms") == 0.0:
        want["batch_window_ms"] = None
        if "batch_max_rows" in want:
            want["batch_max_rows"] = None
    return {k: (v, effective.get(k)) for k, v in want.items() if effective.get(k) != v}


def phase_tune(torch, dev, workdir: str) -> dict:
    """``tune``: config 13's shape (``bench.py:3032-3140``) on the card.
    ``cli serve`` (``aio``, ``auto`` -> ``kernel``, the built-in defaults)
    in its own process serves the 1024-wide MLP; the ``uniform_row`` and
    ``heavy_tail_row`` profiles drive it 4 s each (not 8), with their
    request and results logs written; ``cli tune`` fits on both with the
    dispatch-cost probe on the card at (1, 8, 64, 256, 512, 1024, 4096), 5
    reps: exit 0, one JSON document, the tuned document valid, a cost
    model with held-out mean relative error <= 0.5 (config 18's bound),
    ``tune status`` exit 0 and the store's ``tuning/`` clean under fsck.
    The service restarts with ``--tuned-config latest --cost-budget-s
    4.0 --online-tune --reload-interval 1`` (no watch logs: the controller
    idles): ``/healthz`` ``effective_config`` must hold the document's
    knobs and its digest, ``tuning`` reported; both profiles again, every
    200 (single rows and batches) held against the plain version at the
    ``kernel`` bar. Printed, not required: default against tuned p50/p99
    and goodput per profile, the probe's curve, the knobs and their
    decisions."""
    from bodywork_tpu_torch.audit import run_fsck
    from bodywork_tpu_torch.models import load_model
    from bodywork_tpu_torch.ops.mlp_kernel import make_kernel_mlp_apply
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.tune.config import load_tuned_config

    store = _serving_models(torch, dev, workdir)[0]
    root = str(store.root)
    layers = make_kernel_mlp_apply(load_model(store, device=dev)[0].params, dev).layers
    profiles = _profile_logs(TUNE["drive_s"])
    runs, launches = {}, 0
    # the tuned service also rides the online controller (no watch logs:
    # it idles), so /healthz reports a tuning state
    for mode, args in (("default", []), ("tuned", [
            "--tuned-config", "latest", "--cost-budget-s", str(TUNE["cost_budget_s"]),
            "--online-tune"])):
        if mode == "tuned":
            traces = [p for name in profiles for p in runs["default"][name][2:4]]
            fit = _cli(["tune", "--store", root, "--device", "cuda",
                        *[a for path in traces[0::2] for a in ("--traffic-log", path)],
                        *[a for path in traces[1::2] for a in ("--results-log", path)],
                        "--probe-buckets", TUNE["probe_buckets"],
                        "--probe-reps", str(TUNE["probe_reps"])])
            if fit["rc"] != 0:
                raise RuntimeError(f"cli tune exited {fit['rc']}: {fit['err'][-3000:]}")
            tuned = json.loads(fit["out"])  # one JSON document
            status = _cli(["tune", "status", "--store", root])
            knobs, digest, doc = load_tuned_config(open_store(root), "latest")
            fsck = run_fsck(open_store(root))
            tuning_findings = [f for f in fsck["findings"] if f["key"].startswith("tuning/")]
        service = _ServeProcess(root, reload_interval=1.0 if mode == "tuned" else 0.0,
                                args=args)
        try:
            health = service.health() if mode == "default" else _wait_for(
                lambda: (lambda h: h if h["tuning"] is not None else None)(service.health()),
                10.0) or service.health()
            runs[mode] = {name: _logged_drive(service.base_url, config, requests,
                                              workdir, f"{mode}-{name}")
                          for name, (config, requests) in profiles.items()}
            after = service.health()
        finally:
            stopped = service.stop()
        launches += after["launches"] or 0
        if after["engine"] != "kernel":
            raise RuntimeError(f"tune: {mode} served through {after['engine']!r}")
        runs[mode]["health"], runs[mode]["sigterm"] = health, stopped
        runs[mode]["checks"] = {name: _rows_check(torch, dev, layers, runs[mode][name][1])
                                for name in profiles}
    health = runs["tuned"]["health"]
    effective = health["effective_config"]
    holdout = (tuned.get("cost_model") or {}).get("holdout") or {}
    mismatch = _effective_mismatch(knobs or {}, effective)
    by_profile = {name: {mode: _load_line(runs[mode][name][0]) for mode in ("default", "tuned")}
                  for name in profiles}
    out = {
        "cli_tune_rc": fit["rc"], "cli_tune_s": fit["seconds"], "key": tuned.get("key"),
        "digest": tuned.get("digest"), "knobs": tuned["knobs"],
        "decisions": [{k: d[k] for k in ("knob", "chosen", "default", "source", "basis")}
                      for d in tuned["decisions"]],
        "probe_curve_s": tuned["observations"]["dispatch_cost_s"],
        "observations": {k: tuned["observations"][k] for k in (
            "arrival_rate_rps", "row_shape", "service_rate_rps", "sources")},
        "cost_model": tuned.get("cost_model"), "cost_holdout_bound": TUNE["cost_holdout_bound"],
        "tune_status_rc": status["rc"], "tuning_fsck_findings": tuning_findings,
        "document_valid": knobs is not None and digest == tuned.get("digest"),
        "effective_config": effective, "effective_mismatch": mismatch,
        "tuning": health["tuning"], "admission_cost_shed": (health["admission"] or {}).get(
            "cost_shed"),
        "by_profile": by_profile,
        "plain_checks": {mode: runs[mode]["checks"] for mode in ("default", "tuned")},
        "graph_cache": {mode: runs[mode]["health"]["graph_cache"] for mode in runs},
        "launches": {**dict.fromkeys(VARIANTS, 0), "kernel": launches},
    }
    emit("tune", **out)
    failed = [(m, n) for m in ("default", "tuned") for n, c in runs[m]["checks"].items()
              if not c["err_over_scale"] < BARS["kernel"]]
    if (failed or status["rc"] != 0 or tuning_findings or not out["document_valid"]
            or not holdout or not holdout["mean_rel_err"] <= TUNE["cost_holdout_bound"]
            or mismatch or effective["tuned_config"] != digest or health["tuning"] is None
            or launches < 1):
        raise RuntimeError(f"tune: {out} plain-version misses {failed} {status['err'][-2000:]}")
    return out


def _wait_for(predicate, timeout_s: float, tick_s: float = 0.02):
    """``predicate()``'s first truthy value within ``timeout_s``, else its
    last value."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(tick_s)
    return predicate()


def phase_online_tune(torch, dev, workdir: str) -> dict:
    """``online-tune``: config 18's shape (``bench.py:4620-4700``) on the
    card, in process: the dispatch-cost probe's curve (``torch`` engine,
    3 reps) fits the cost model, then ``serve_latest_model`` (``aio``,
    ``auto`` -> ``kernel``, coalescer 2 ms / 64 rows, ``max_pending``
    512, the cost-priced shed armed at 4.0 s) boots with every power of
    two <= 512 as its ladder, warmed, ``online_tune`` on and the watcher
    polling every 0.25 s, tracing at 1.0. Phase A (Poisson 60/s, 5 s)
    pins the controller's reference; phase B (180/s, 5 s) is appended to
    its watch log while in flight: the controller must apply a refit (a
    config-log ``applied`` entry, one CAS) that graduates; the graph
    cache's captures and misses must not move after boot and nothing
    rebinds; every request answers 200, held against the plain version
    at the ``kernel`` bar; a fixed probe request's body is byte-identical
    before and after; ``shed_total{reason="cost"}`` stays 0. Then the
    sabotage: ``apply_tuned`` of a 900 ms window must be reverted within
    the guard's poll budget in exactly one config-log CAS (counted at the
    store) with the flight-record key in the revert event. Then a ladder
    holding 1024, a rung not captured at boot, is applied mid-drive from
    the watcher's poll: it must be captured on the watcher's thread,
    exactly once, with every request 200 and none slower than 5x the
    drive's p99."""
    import threading

    from bodywork_tpu_torch.models import load_model
    from bodywork_tpu_torch.obs.tracing import configured_tracing
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, make_kernel_mlp_apply, reset_launches
    from bodywork_tpu_torch.ops.slo import _sum_counter
    from bodywork_tpu_torch.registry.configlog import read_config_log
    from bodywork_tpu_torch.serve import GRAPH_CACHE, serve_latest_model
    from bodywork_tpu_torch.serve import predictor as predictor_module
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.base import DelegatingStore
    from bodywork_tpu_torch.store.schema import CONFIG_LOG_KEY
    from bodywork_tpu_torch.traffic import TrafficConfig, generate_request_log, write_request_log
    from bodywork_tpu_torch.tune.collect import probe_dispatch_costs
    from bodywork_tpu_torch.tune.config import write_tuned_config
    from bodywork_tpu_torch.tune.costmodel import (
        fit_cost_model,
        samples_from_probe,
        write_cost_model,
    )

    class CasCounting(DelegatingStore):
        """Counts ``put_bytes_if_match`` per key at the store boundary, so a
        one-CAS claim is counted where it lands."""

        def __init__(self, inner):
            super().__init__(inner)
            self.cas_calls: dict = {}

        def put_bytes_if_match(self, key, data, expected_token=None):
            self.cas_calls[key] = self.cas_calls.get(key, 0) + 1
            return self.inner.put_bytes_if_match(key, data, expected_token)

    cfg = ONLINE_TUNE
    _serving_models(torch, dev, workdir)
    store = CasCounting(FilesystemStore(os.path.join(workdir, "serving-store")))
    layers = make_kernel_mlp_apply(load_model(store, device=dev)[0].params, dev).layers
    ladder = tuple(2 ** i for i in range(10))  # every rung a refit can pick
    t0 = time.perf_counter()
    curve = probe_dispatch_costs(store, ladder, reps=cfg["probe_reps"], device=dev)
    cm_doc = fit_cost_model(samples_from_probe(curve, n_features=1), seed=18)
    write_cost_model(store, cm_doc, date(2026, 7, 3))
    probe_s = time.perf_counter() - t0
    tune_env = {"BODYWORK_TPU_TUNE_MIN_WINDOW_REQUESTS": str(cfg["min_window_requests"]),
                "BODYWORK_TPU_TUNE_DRIFT_THRESHOLD": "0.5",
                "BODYWORK_TPU_TUNE_COOLDOWN_POLLS": str(cfg["cooldown_polls"]),
                "BODYWORK_TPU_TUNE_VERDICT_POLLS": str(cfg["verdict_polls"]),
                "BODYWORK_TPU_TUNE_MIN_VERDICT_REQUESTS": str(cfg["min_verdict_requests"]),
                "BODYWORK_TPU_TUNE_REVERT_P99_RATIO": str(cfg["revert_p99_ratio"])}
    saved_env = {k: os.environ.get(k) for k in tune_env}
    os.environ.update(tune_env)
    watch_log = os.path.join(workdir, "live.requests.jsonl")
    # which thread each capture ran on
    captured_on = []
    build = predictor_module._BucketGraph.__init__

    def recording_build(self, *args, **kwargs):
        build(self, *args, **kwargs)
        if self.graph is not None:
            captured_on.append((threading.current_thread().name, int(self.x.shape[0])))

    predictor_module._BucketGraph.__init__ = recording_build
    refits = lambda: _sum_counter("bodywork_tpu_tune_online_refits_total", outcome="applied")  # noqa: E731
    reverts = lambda: _sum_counter("bodywork_tpu_tune_online_reverts_total")  # noqa: E731
    cost_sheds = lambda: _sum_counter("bodywork_tpu_serve_shed_total", reason="cost")  # noqa: E731
    base = {"refits": refits(), "reverts": reverts(), "cost_sheds": cost_sheds()}
    handle = None
    reset_launches()
    try:
        with configured_tracing(1.0, seed=18):
            t_boot = time.perf_counter()
            handle = serve_latest_model(
                store, host="127.0.0.1", port=0, block=False, device=dev,
                server_engine="aio", watch_interval_s=cfg["poll_s"], buckets=ladder,
                max_pending=512, batch_window_ms=2.0, batch_max_rows=64, online_tune=True,
                tune_request_logs=(watch_log,), cost_budget_s=cfg["cost_budget_s"])
            boot_s = time.perf_counter() - t_boot
            app = handle.app
            controller = app.tune_controller
            watcher = handle.watcher
            if app.predictor.engine != "kernel":
                raise RuntimeError(f"online-tune: auto served {app.predictor.engine!r}")
            cost_shed = app.admission.state()["cost_shed"]
            at_boot = GRAPH_CACHE.stats()
            captures_at_boot = len(captured_on)
            probe = {"X": [50.0]}
            body_boot = post_raw(handle.base_url + "/score/v1", probe)
            # phase A pins the reference
            cfg_a = TrafficConfig(rate_rps=cfg["phase_a_rps"], duration_s=cfg["phase_a_s"],
                                  seed=181)
            requests_a = generate_request_log(cfg_a)
            write_request_log(watch_log, cfg_a, requests_a)
            report_a, answers_a = _drive(handle.base_url, requests_a, shards=1)
            reference = _wait_for(lambda: controller._reference, 20.0)
            # phase B: the shape shift appended to the watch log mid-drive
            requests_b = generate_request_log(TrafficConfig(
                rate_rps=cfg["phase_b_rps"], duration_s=cfg["phase_b_s"], seed=182))

            def append_phase_b():
                offset = cfg["phase_a_s"] + 0.2 * cfg["phase_b_s"]
                with open(watch_log, "a") as f:
                    for r in requests_b:
                        f.write(json.dumps({"t_s": round(r.t_s + offset, 9), "route": r.route,
                                            "rows": r.rows, "x": list(r.x)}) + "\n")

            cas_before = store.cas_calls.get(CONFIG_LOG_KEY, 0)
            appender = threading.Timer(0.2 * cfg["phase_b_s"], append_phase_b)
            appender.start()
            try:
                report_b, answers_b = _drive(handle.base_url, requests_b, shards=1)
            finally:
                appender.join()
            t_wait = time.perf_counter()
            refit_applied = bool(_wait_for(lambda: refits() - base["refits"] >= 1, 20.0))
            _wait_for(lambda: controller._guard is None,
                      cfg["verdict_polls"] * cfg["poll_s"] + 20.0)
            graduated = controller._guard is None and reverts() == base["reverts"]
            graduate_wait_s = time.perf_counter() - t_wait
            cas_refit = store.cas_calls.get(CONFIG_LOG_KEY, 0) - cas_before
            refit_entry = (read_config_log(store) or {}).get("active") or {}
            body_refit = post_raw(handle.base_url + "/score/v1", probe)
            after_drive = GRAPH_CACHE.stats()
            effective_refit = app.effective_config()
            # the sabotage: an absurd but valid window, through apply_tuned
            calibration = generate_request_log(TrafficConfig(
                rate_rps=cfg["calibration_rps"], duration_s=cfg["calibration_s"], seed=183))
            report_cal, answers_cal = _drive(handle.base_url, calibration, shards=1)
            sab_knobs = {"batch_window_ms": cfg["sabotage_window_ms"]}
            sab_key, sab_digest = write_tuned_config(
                store, {"knobs": sab_knobs, "decisions": [],
                        "note": "chip_smoke sabotage: a valid config with an absurd window"},
                day=date(2026, 9, 18))
            cas_before = store.cas_calls.get(CONFIG_LOG_KEY, 0)
            t_sab = time.perf_counter()
            sab_applied = controller.apply_tuned(
                sab_knobs, sab_key, sab_digest,
                reason=f"chip_smoke_sabotage(window_ms={cfg['sabotage_window_ms']})")
            cas_sab_apply = store.cas_calls.get(CONFIG_LOG_KEY, 0) - cas_before
            sabotage = generate_request_log(TrafficConfig(
                rate_rps=cfg["sabotage_rps"], duration_s=cfg["sabotage_drive_s"], seed=184))
            report_sab, answers_sab = _drive(handle.base_url, sabotage, shards=1)
            reverted = bool(_wait_for(lambda: reverts() - base["reverts"] >= 1,
                                      cfg["verdict_polls"] * cfg["poll_s"] + 20.0))
            revert_s = time.perf_counter() - t_sab
            cas_revert = store.cas_calls.get(CONFIG_LOG_KEY, 0) - cas_before - cas_sab_apply
            log_doc = read_config_log(store) or {}
            revert_events = [e for e in log_doc.get("history", []) if e["event"] == "reverted"]
            revert_event = revert_events[-1] if revert_events else {}
            effective_revert = app.effective_config()
            body_revert = post_raw(handle.base_url + "/score/v1", probe)
            # a new rung, applied from the watcher's own poll mid-drive
            _wait_for(lambda: controller._cooldown == 0 and controller._guard is None, 10.0)
            new_ladder = [*ladder[:7], cfg["new_rung"]]
            rung_box: dict = {}
            poll = controller.poll

            def poll_with_rung():
                if "want" in rung_box and "done" not in rung_box:
                    rung_box["done"] = True
                    t = time.perf_counter()
                    rung_box["action"] = controller.apply_tuned(
                        {"buckets": new_ladder}, "tuning/chip-smoke-rung.json",
                        "sha256:chip-smoke-rung", reason="chip_smoke_new_rung")
                    rung_box["apply_s"] = time.perf_counter() - t
                    rung_box["thread"] = threading.current_thread().name
                return poll()

            # the boot window back first: the revert restored the refit's
            # knobs, whose window of 0 (coalescing off) is not applied live,
            # so the sabotage's 900 ms window is still in force
            window_before_rung = app.batcher.reconfigure(window_ms=2.0)
            controller.poll = poll_with_rung
            captures_before = len(captured_on)
            stats_before = GRAPH_CACHE.stats()
            timer = threading.Timer(1.0, lambda: rung_box.setdefault("want", True))
            timer.start()
            rung_log = generate_request_log(TrafficConfig(
                rate_rps=cfg["rung_rps"], duration_s=cfg["rung_drive_s"], seed=185))
            rung_results = os.path.join(workdir, "new-rung.results.jsonl")
            report_rung, answers_rung = _drive(handle.base_url, rung_log, shards=1,
                                               results_log=rung_results)
            timer.join()
            _wait_for(lambda: "action" in rung_box, 10.0)
            controller.poll = poll
            stats_rung = GRAPH_CACHE.stats()
            new_captures = captured_on[captures_before:]
            effective_rung = app.effective_config()
            health = get(handle.base_url + "/healthz")
            launches = dict(LAUNCHES)
    finally:
        predictor_module._BucketGraph.__init__ = build
        if handle is not None:
            handle.stop()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    drives = {"phase_a": (report_a, answers_a), "phase_b": (report_b, answers_b),
              "calibration": (report_cal, answers_cal), "sabotage": (report_sab, answers_sab),
              "new_rung": (report_rung, answers_rung)}
    checks = {name: _rows_check(torch, dev, layers, a) for name, (_r, a) in drives.items()}
    rung_p99 = report_rung["latency"]["p99_s"]
    with open(rung_results) as f:
        rung_max = max((json.loads(line).get("latency_s") or 0.0 for line in f if line.strip()),
                       default=None)
    out = {
        "probe_curve_s": curve, "probe_and_fit_s": probe_s, "boot_s": boot_s,
        "cost_model_holdout": cm_doc["holdout"], "cost_shed_at_boot": cost_shed,
        "cost_sheds": cost_sheds() - base["cost_sheds"],
        "reference": reference, "refit_applied": refit_applied, "refit_cas": cas_refit,
        "refit_knobs": refit_entry.get("knobs"), "effective_after_refit": effective_refit,
        "graduated": graduated, "graduate_wait_s": graduate_wait_s,
        "graph_cache_at_boot": at_boot, "graph_cache_after_drive": after_drive,
        "captures_at_boot": captures_at_boot,
        "probe_body_identical": body_boot == body_refit == body_revert,
        "drives": {name: {**_load_line(r), "checks": checks[name]}
                   for name, (r, _a) in drives.items()},
        "sabotage": {"applied": sab_applied, "apply_cas": cas_sab_apply,
                     "reverted": reverted, "revert_cas": cas_revert, "revert_s": revert_s,
                     "poll_budget_s": cfg["verdict_polls"] * cfg["poll_s"],
                     "flight_record": revert_event.get("flight_record"),
                     "reason": revert_event.get("reason"),
                     "window_after_revert": effective_revert["batch_window_ms"],
                     "window_reset_before_rung": window_before_rung},
        "new_rung": {"ladder": new_ladder, "action": rung_box.get("action"),
                     "applied_on": rung_box.get("thread"), "apply_s": rung_box.get("apply_s"),
                     "captures": new_captures,
                     "misses": stats_rung["misses"] - stats_before["misses"],
                     "rebinds": stats_rung["rebinds"] - stats_before["rebinds"],
                     "buckets_live": effective_rung["buckets"],
                     "p99_ms": 1e3 * rung_p99 if rung_p99 else None,
                     "max_ms": 1e3 * rung_max if rung_max else None},
        "tuning": health["tuning"], "watcher_thread": watcher._thread.name,
        "launches": {**dict.fromkeys(VARIANTS, 0), **{k: launches.get(k, 0) for k in VARIANTS}},
    }
    emit("online-tune", **out)
    moved = {k: after_drive[k] - at_boot[k] for k in ("captures", "misses", "rebinds")}
    bad_checks = [n for n, c in checks.items() if not c["err_over_scale"] < BARS["kernel"]]
    not_ok = [n for n, (r, _a) in drives.items() if r["ok"] != r["requests"]]
    rung = out["new_rung"]
    if (not refit_applied or cas_refit != 1 or not graduated or any(moved.values())
            or not out["probe_body_identical"] or out["cost_sheds"] or cost_shed is None
            or bad_checks or not_ok or sab_applied != "applied" or not reverted
            or cas_revert != 1 or not revert_event.get("flight_record")
            or out["sabotage"]["revert_s"] > out["sabotage"]["poll_budget_s"] + 5.0
            or rung["action"] != "applied" or rung["applied_on"] != watcher._thread.name
            or [(t, b) for t, b in new_captures] != [(watcher._thread.name, cfg["new_rung"])]
            or rung["rebinds"] or rung["max_ms"] is None or rung["p99_ms"] is None
            or rung["max_ms"] > cfg["slow_factor"] * rung["p99_ms"]
            or launches.get("kernel", 0) < 1):
        raise RuntimeError(f"online-tune: {out} moved {moved} plain misses {bad_checks} "
                           f"not all 200 {not_ok}")
    return out


def phase_ab(torch, dev, workdir: str) -> dict:
    """``ab``: ``run_ab_simulation`` of ``["linear", "mlp"]`` on the card,
    3 days, the MLP at hidden (1024, 1024, 1024) with the soaks' training
    settings: the pair concurrently, then each variant solo in this
    process; each variant's datasets, checkpoints, metrics and registry
    records byte-identical to its solo run (journals and snapshots left
    out, the test metrics' wall-clock column masked, as
    :func:`_compare_results` does). The pair's wall-clock against the sum
    of the solos; launches counted over the pair."""
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import (
        compare_report,
        run_ab_simulation,
        variants_from_model_types,
    )
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE

    def variants(models):
        vs = variants_from_model_types(models)
        for v in vs:
            if v.name.endswith("mlp"):
                v.spec.stages[TRAIN_STAGE].args.update(SOAK_MLP)
        return vs

    reset_launches()
    t0 = time.perf_counter()
    pair = run_ab_simulation(variants(["linear", "mlp"]), os.path.join(workdir, "pair"),
                             LOOP_START, AB["days"], devices=[dev])
    pair_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    solo_s, compared = {}, {}
    for name, variant in zip(("a-linear", "b-mlp"), variants(["linear", "mlp"])):
        t0 = time.perf_counter()
        solo = run_ab_simulation([variant], os.path.join(workdir, f"solo-{name}"), LOOP_START,
                                 AB["days"], devices=[dev])
        solo_s[name] = time.perf_counter() - t0
        if solo[name].error is not None:
            raise RuntimeError(f"ab: the solo {name} run failed: {solo[name].error!r}")
        compared[name] = _compare_results(
            _results_of(os.path.join(workdir, "pair", name)),
            _results_of(os.path.join(workdir, f"solo-{name}", name)))
    errors = {k: repr(v.error) for k, v in pair.items() if v.error is not None}
    out = {"days": AB["days"], "pair_s": pair_s, "solo_s": solo_s,
           "sum_of_solos_s": sum(solo_s.values()),
           "pair_over_sum_of_solos": pair_s / sum(solo_s.values()),
           "pair_errors": errors, "compared": compared,
           "report_rows": len(compare_report(pair)), "launches": launches}
    emit("ab", **out)
    if errors or any(c["differ"] or c["only_in_first"] or c["only_in_second"]
                     for c in compared.values()) or launches["kernel"] < 1:
        raise RuntimeError(f"ab: a variant of the pair is not its solo run: {out}")
    return out


def _day_line(model_type: str, r, launched: int) -> dict:
    """One simulated day's readings from its ``DayResult``."""
    from bodywork_tpu_torch.pipeline.spec import SERVE_STAGE, TEST_STAGE, TRAIN_STAGE

    from bodywork_tpu_torch.pipeline.runner import GATE_RESULT
    from bodywork_tpu_torch.registry import GateDecision

    train = r.stage_results[TRAIN_STAGE]
    test = r.stage_results[TEST_STAGE]
    gate = r.stage_results.get(GATE_RESULT)
    health = r.stage_results[SERVE_STAGE].app.healthz_payload()
    line = {
        "model": model_type, "day": str(r.day), "engine": health["engine"],
        "device": health["device"], "model_info": health["model_info"],
        "launches": launched,
        "gate": ({"promote": gate.promote, "candidate": gate.model_key,
                  "checks": {c["name"]: c["ok"] for c in gate.checks}}
                 if isinstance(gate, GateDecision) else repr(gate)),
        "gate_seconds": r.gate_seconds,
        "served_key": health["model_key"], "served_source": health["model_source"],
        "train_rows": train.n_rows, "train_mode": train.mode,
        "fallback_reason": train.fallback_reason, "rows_touched": train.rows_touched,
        "train_metrics": train.metrics,
        "test_metrics": {k: test[k] for k in ("MAPE", "r_squared", "max_residual",
                                             "n_failures", "n_scored")},
        "wall_clock_s": r.wall_clock_s, "stage_seconds": r.stage_seconds,
        # the overlap: whether generate persisted prefetched draws, and the
        # lookahead train's own seconds on its thread (the train stage's
        # seconds are then its wait for that thread)
        "prefetched": r.prefetched, "lookahead_train_s": r.lookahead_train_s,
    }
    values = [*train.metrics.values(), test["MAPE"]]
    if not all(math.isfinite(v) for v in values) or test["n_failures"] != 0:
        raise RuntimeError(f"{model_type} day {r.day} is not healthy: {line}")
    # a gate that raised is logged and the day goes on; here it fails the phase
    if not isinstance(gate, GateDecision) or health["model_source"] != "production":
        raise RuntimeError(f"{model_type} day {r.day} was not gated and served from "
                           f"production: {line}")
    return line


def _array_holds(a) -> dict:
    """Type, device, dtype and bytes of one array a box or result holds."""
    import torch

    if isinstance(a, torch.Tensor):
        return {"type": "torch.Tensor", "device": str(a.device), "dtype": str(a.dtype),
                "bytes": a.numel() * a.element_size()}
    return {"type": f"{type(a).__module__}.{type(a).__name__}", "device": "host",
            "dtype": str(a.dtype), "bytes": int(a.nbytes)}


def _prefetch_box(runner) -> dict:
    """What the oldest prefetch box that no generate stage has popped yet
    holds, read from the runner between two days (its draws made on the
    worker thread). Fails unless X and y are host numpy arrays, as the
    generator returns them: a box on the card would pin device memory
    across days."""
    import numpy as np

    with runner._gen_lock:
        pending = sorted(runner._dataset_boxes.items(), key=lambda kv: kv[0])
    if not pending:
        return {"pending_boxes": 0}
    target, box = pending[0]
    if not box["ready"].wait(120) or "X" not in box:
        raise RuntimeError(f"the prefetch box for {target} was not filled")
    held = {"target": str(target), "pending_boxes": len(pending),
            "X": _array_holds(box["X"]), "y": _array_holds(box["y"])}
    if not all(isinstance(box[k], np.ndarray) for k in ("X", "y")):
        raise RuntimeError(f"the prefetch box does not hold host numpy arrays: {held}")
    return held


#: (model, fit bucket, eval bucket) the script's day loops have trained at
_LOOP_BUCKETS: set = set()


def _row_buckets(model_type: str, n_rows: int) -> dict:
    """The fit and eval row buckets a day's ``n_rows`` of history train at
    (the trainer's split, ``train_test_split``, padded by
    ``models/base.py::_bucket_rows``, the fit to >= 1024 rows, the
    held-out split to >= 256), and whether
    this process's day loops meet the pair for the first time: the day
    the JAX package's prewarm exists for (an XLA compile per bucket)."""
    import numpy as np

    from bodywork_tpu_torch.models.base import _bucket_rows, train_test_split

    split = train_test_split(np.empty((n_rows, 0)), np.empty(n_rows))
    fit, held_out = _bucket_rows(len(split.y_train)), _bucket_rows(len(split.y_test), 256)
    new = (model_type, fit, held_out) not in _LOOP_BUCKETS
    _LOOP_BUCKETS.add((model_type, fit, held_out))
    return {"fit": fit, "eval": held_out, "new_to_process": new}


def _bucket_crossings(days: list) -> dict:
    """Days 2 on whose row buckets are new to the process, each beside
    the spread of the other days' fits: the lookahead's own train
    seconds (the fit on its thread) and the train stage's."""
    keys = ("lookahead_train_s", "train_stage_s")
    steady = [d for d in days[1:] if not d["row_buckets"]["new_to_process"]]
    spread = {}
    for k in keys:
        values = [d[k] for d in steady if d[k] is not None]
        spread[k] = [min(values), max(values)] if values else None
    crossings = []
    for d in days[1:]:
        if d["row_buckets"]["new_to_process"]:
            crossings.append({"day": d["day"], **d["row_buckets"], **{k: d[k] for k in keys},
                              "outside_spread": {k: None if spread[k] is None or d[k] is None
                                                 else not spread[k][0] <= d[k] <= spread[k][1]
                                                 for k in keys}})
    return {"crossings": crossings, "steady_days": len(steady), "steady_spread_s": spread}


def _run_loop(torch, dev, root: str, model_type: str, train_args: dict,
              n_days: int = LOOP_DAYS, line: str = "day-loop-day", on_day=None,
              overlap_generate: bool = False) -> dict:
    """``n_days`` days of the default pipeline on the card, through
    ``run_simulation`` (the journal, the horizon prefetch, the lookahead
    train and the compactor); the kernels' launch counts are set to 0 just
    before it and read just after. Fails unless every day persisted
    prefetched draws and every day but the first collected a lookahead: a
    background step that fell back inline would hide a failure on the
    card. ``on_day(r)`` runs after each day's line; after the first day's,
    a pending prefetch box is read (``_prefetch_box``)."""
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import SERVE_STAGE, TRAIN_STAGE
    from bodywork_tpu_torch.serve import GRAPH_CACHE
    from bodywork_tpu_torch.store import FilesystemStore

    spec = default_pipeline(model_type, "batch", overlap_generate=overlap_generate)
    spec.stages[TRAIN_STAGE].args.update(train_args)
    name = f"{model_type}-{train_args.get('mode', 'full')}"
    runner = LocalRunner(spec, FilesystemStore(os.path.join(root, name)), device=dev)
    days, seen, box = [], {"kernel": 0, "captures": 0}, {}

    def _on_day(r):
        launched = LAUNCHES["kernel"] - seen["kernel"]
        seen["kernel"] = LAUNCHES["kernel"]
        captures = GRAPH_CACHE.stats()["captures"]
        day = _day_line(model_type, r, launched)
        days.append({**day, "graph_captures": captures - seen["captures"],
                     "buckets": r.stage_results[SERVE_STAGE].app.predictor.buckets,
                     "row_buckets": _row_buckets(model_type, day["train_rows"]),
                     "train_stage_s": r.stage_seconds[TRAIN_STAGE]})
        seen["captures"] = captures
        emit(line, **days[-1])
        if not box:
            box.update(_prefetch_box(runner))
        if on_day is not None:
            on_day(r)

    # a cold graph cache: day 1 captures its buckets, later days rebind
    GRAPH_CACHE.reset()
    reset_launches()
    results = runner.run_simulation(LOOP_START, n_days, on_day=_on_day)
    launches = dict(LAUNCHES)
    walls = [r.wall_clock_s for r in results]
    stages = {name: statistics.median(r.stage_seconds[name] for r in results[1:])
              for name in results[0].stage_seconds}
    prefetched = sum(r.prefetched for r in results)
    collected = sum(r.lookahead_train_s is not None for r in results)
    summary = {"model": model_type, "days": n_days, "launches": launches,
               "engines": sorted({d["engine"] for d in days}),
               "gate_verdicts": [d["gate"]["promote"] for d in days],
               "served_sources": sorted({d["served_source"] for d in days}),
               "gate_seconds": [r.gate_seconds for r in results],
               "median_gate_seconds_days_2_on": statistics.median(
                   r.gate_seconds for r in results[1:]),
               "wall_clock_s": walls, "day1_s": walls[0],
               "median_days_2_on_s": statistics.median(walls[1:]),
               "median_stage_seconds_days_2_on": stages,
               "prefetched": prefetched, "lookaheads_collected": collected,
               "lookahead_train_s": [r.lookahead_train_s for r in results],
               "graph_captures_per_day": [d["graph_captures"] for d in days],
               "row_buckets_per_day": [d["row_buckets"] for d in days],
               "bucket_crossings": _bucket_crossings(days),
               "prefetch_box_after_day_1": box,
               "runs_through": "run_simulation: journal, horizon prefetch, lookahead train and "
                       "compactor; the train stage's seconds are its wait "
                       "for the lookahead from day 2 on"}
    if prefetched != n_days or collected != n_days - 1:
        raise RuntimeError(f"{name}: {prefetched} prefetched of {n_days} days, "
                           f"{collected} lookaheads collected of {n_days - 1}: a "
                           "background step fell back inline")
    captures = summary["graph_captures_per_day"]
    if captures[0] != len(days[0]["buckets"]) or any(captures[1:]):
        raise RuntimeError(f"{name}: graph captures per day {captures}: day 1 must capture "
                           f"its {len(days[0]['buckets'])} buckets and later days none")
    return {"summary": summary, "days": days, "runner": runner, "results": results}


def _strip_column(data: bytes, column: str) -> bytes:
    """A CSV without one column, textually (every other byte kept)."""
    lines = data.decode().splitlines()
    header = lines[0].split(",")
    if column not in header:
        return data
    i = header.index(column)
    return "\n".join(",".join(f for j, f in enumerate(line.split(",")) if j != i)
                     for line in lines).encode()


def _results_of(root: str) -> dict:
    """The store's results by key, as the chaos soak compares them
    (``chaos.sim._COMPARE_EXCLUDED`` left out: the journals and snapshots,
    which are operational state, and the audit sidecars that hash a wall
    clock or version tokens), the test metrics without their wall-clock
    response time."""
    from bodywork_tpu_torch.chaos.sim import _COMPARE_EXCLUDED
    from bodywork_tpu_torch.store import FilesystemStore

    store = FilesystemStore(root)
    return {key: (_strip_column(store.get_bytes(key), "mean_response_time")
                  if key.startswith("test-metrics/") else store.get_bytes(key))
            for key in store.list_keys() if not key.startswith(_COMPARE_EXCLUDED)}


def _compare_results(a: dict, b: dict) -> dict:
    """Keys on one side only, and keys whose bytes differ."""
    return {"compared": len(set(a) & set(b)),
            "only_in_first": sorted(set(a) - set(b)),
            "only_in_second": sorted(set(b) - set(a)),
            "differ": sorted(k for k in set(a) & set(b) if a[k] != b[k])}


def _params_bytes(params) -> tuple[int, list]:
    """Bytes and devices of a model's parameter tensors."""
    import torch

    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size(), [str(params.device)]
    items = params.values() if isinstance(params, dict) else params
    total, devices = 0, []
    for p in items:
        n, d = _params_bytes(p)
        total += n
        devices += d
    return total, devices


def _pipelined(torch, dev, workdir: str, mlp: dict) -> dict:
    """The MLP loop's first SERIAL_DAYS days (``run_simulation``, its store
    copied after day SERIAL_DAYS) against a serial loop of plain
    ``run_day(..., lookahead_train=False)`` calls with no prefetch:
    datasets, checkpoints, metrics and registry records byte-identical.
    The per-day overlap readings and what the background steps hold."""
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import TEST_STAGE, TRAIN_STAGE
    from bodywork_tpu_torch.store import FilesystemStore

    spec = default_pipeline("mlp", "batch")
    spec.stages[TRAIN_STAGE].args.update(LOOP_MLP)
    serial = LocalRunner(spec, FilesystemStore(os.path.join(workdir, "serial")), device=dev)
    serial._enqueue_generate = lambda targets: None  # no prefetch: generate inline
    serial.bootstrap(LOOP_START)
    reset_launches()
    serial_days = [serial.run_day(LOOP_START + timedelta(days=i), lookahead_train=False)
                   for i in range(SERIAL_DAYS)]
    serial_launches = dict(LAUNCHES)
    gap = _compare_results(_results_of(mlp["copy"]), _results_of(serial.store.root))
    results = mlp["results"]
    model = results[1].stage_results[TRAIN_STAGE].model
    param_bytes, param_devices = _params_bytes(model.params)
    out = {
        "days": len(results), "serial_days": SERIAL_DAYS,
        "prefetched": sum(r.prefetched for r in results),
        "lookaheads_collected": sum(r.lookahead_train_s is not None for r in results),
        "per_day": [{"day": str(r.day), "train_stage_s": r.stage_seconds[TRAIN_STAGE],
                     "lookahead_train_s": r.lookahead_train_s,
                     "test_stage_s": r.stage_seconds[TEST_STAGE],
                     "wall_clock_s": r.wall_clock_s} for r in results],
        "serial_per_day": [{"day": str(r.day), "train_stage_s": r.stage_seconds[TRAIN_STAGE],
                            "test_stage_s": r.stage_seconds[TEST_STAGE],
                            "wall_clock_s": r.wall_clock_s} for r in serial_days],
        "serial_launches": serial_launches,
        "byte_identity": gap,
        # what the background steps hold while the next day runs: a box
        # read between days 1 and 2, and day 2's collected lookahead model
        "prefetch_box": mlp["summary"]["prefetch_box_after_day_1"],
        "lookahead_result": {"holds": f"TrainResult, {type(model).__name__} params",
                             "bytes": param_bytes, "devices": sorted(set(param_devices))},
    }
    emit("pipelined", **out)
    if out["prefetched"] != len(results) or out["lookaheads_collected"] != len(results) - 1:
        raise RuntimeError(f"a pipelined background step fell back inline: {out}")
    if gap["differ"] or gap["only_in_first"] or gap["only_in_second"] or not gap["compared"]:
        raise RuntimeError(f"the pipelined loop's artefacts differ from the serial ones: {gap}")
    if serial_launches["kernel"] < SERIAL_DAYS:
        raise RuntimeError(f"the serial loop did not serve through the kernel: {serial_launches}")
    overlap = _overlapped(torch, dev, workdir, serial.store.root)
    return {"serial_launches": serial_launches, "overlap_launches": overlap["launches"], **out}


def _overlapped(torch, dev, workdir: str, serial_root: str) -> dict:
    """The overlapped DAG (``default_pipeline(overlap_generate=True)``:
    generate beside serve, ``s1 >> s2,s3 >> s4``) through
    ``run_simulation`` over the serial loop's days, with the same
    no-fallback counts: byte-identical to the serial loop."""
    from bodywork_tpu_torch.pipeline.spec import GENERATE_STAGE, SERVE_STAGE

    loop = _run_loop(torch, dev, os.path.join(workdir, "overlap"), "mlp", LOOP_MLP,
                     n_days=SERIAL_DAYS, line="pipelined-overlap-day", overlap_generate=True)
    gap = _compare_results(_results_of(os.path.join(workdir, "overlap", "mlp-full")),
                           _results_of(serial_root))
    dag = loop["runner"].spec.dag
    out = {**loop["summary"], "dag": dag, "byte_identity_vs_serial": gap}
    emit("pipelined-overlap", **out)
    if [SERVE_STAGE, GENERATE_STAGE] not in dag:
        raise RuntimeError(f"the overlapped DAG does not run generate beside serve: {dag}")
    if gap["differ"] or gap["only_in_first"] or gap["only_in_second"] or not gap["compared"]:
        raise RuntimeError(f"the overlapped loop's artefacts differ from the serial ones: {gap}")
    if any(d["engine"] != "kernel" or d["launches"] < 1 for d in loop["days"]):
        raise RuntimeError(f"the overlapped loop did not serve through the kernel: {out}")
    return out


def phase_day_loop(torch, dev, workdir: str) -> dict:
    """The daily loop on the card for the MLP (gated, and served from the
    production alias by the f32 kernel) and the linear model, a forced
    gate rejection, then the card-against-CPU training check."""
    from bodywork_tpu_torch.data import load_latest_dataset
    from bodywork_tpu_torch.device import matmul_precision
    from bodywork_tpu_torch.models.checkpoint import load_model
    from bodywork_tpu_torch.models.mlp import mlp_apply
    from bodywork_tpu_torch.ops.mlp_kernel import make_kernel_mlp_apply, mlp_stack_plain

    emit("day-loop-precision", **matmul_precision())
    copy = os.path.join(workdir, "mlp-after-serial-days")

    def copy_after(r):
        # the store as the serial loop will leave it: written by days 1-3
        # (the lookahead of day 4 computes but writes nothing yet)
        if r.day == LOOP_START + timedelta(days=SERIAL_DAYS - 1):
            shutil.copytree(os.path.join(workdir, "mlp-full"), copy,
                            ignore=shutil.ignore_patterns("snapshots", "runs"))

    mlp = _run_loop(torch, dev, workdir, "mlp", LOOP_MLP, on_day=copy_after)
    bad = [d["day"] for d in mlp["days"] if d["engine"] != "kernel" or d["launches"] < 1]
    if bad:
        raise RuntimeError(f"the MLP loop did not serve through the kernel on {bad}")
    emit("day-loop", **mlp["summary"])
    pipelined = _pipelined(torch, dev, workdir, {**mlp, "copy": copy})

    # the last day's checkpoint once more: through the kernel on the rows
    # its service was tested on, against its plain version and the plain
    # torch engine
    store = mlp["runner"].store
    model, model_date = load_model(store, device=dev)
    tested = load_latest_dataset(store)
    X = torch.as_tensor(tested.X, device=dev)
    apply = make_kernel_mlp_apply(model.params, dev)
    got = apply(X)
    want = mlp_stack_plain(apply.layers, X, None)
    with torch.no_grad():
        unfolded = mlp_apply(model.params, X)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    rel_unfolded = rel_err(got, unfolded)[1]
    if rel >= BARS["kernel"] or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"the trained model's kernel answers disagree: {rel:.3g}")
    emit("day-loop-served", model_date=str(model_date), rows_of=str(tested.date),
         rows=int(X.shape[0]),
         max_abs_err=err, err_over_scale=rel, bar=BARS["kernel"],
         err_over_scale_vs_unfolded=rel_unfolded)
    rejection = _forced_rejection(torch, dev, store, workdir)

    linear = _run_loop(torch, dev, workdir, "linear", {})
    if linear["summary"]["engines"] != ["torch"] or any(linear["summary"]["launches"].values()):
        raise RuntimeError(f"the linear loop should run no kernel: {linear['summary']}")
    emit("day-loop", **linear["summary"], note="the torch engine: this loop runs no kernel")

    parity = _card_against_cpu(torch, dev, mlp["runner"].store)
    emit("day-loop-train-profile", **_train_profile(torch, dev, mlp["runner"].store))
    return {"mlp": mlp["summary"], "linear": linear["summary"], "served_err": err,
            "card_vs_cpu": parity["max_rel_gap"], "rejection": rejection,
            "pipelined": pipelined}


def _forced_rejection(torch, dev, store, workdir: str) -> dict:
    """On a copy of the MLP loop's store: a day-8 candidate whose held-out
    metrics fail the gate's ``min_r2`` is rejected, and the serve stage
    then serves the previous production through the f32 kernel (launches
    counted from 0 just before the serve stage, read after one request),
    whose answers are held against the plain version of that model."""
    from bodywork_tpu_torch.data.io import csv_record
    from bodywork_tpu_torch.models.checkpoint import load_model, save_model
    from bodywork_tpu_torch.models.mlp import mlp_apply
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline.stages import StageContext, serve_stage
    from bodywork_tpu_torch.registry import GatePolicy, ModelRegistry, register_candidate
    from bodywork_tpu_torch.registry.records import resolve_alias
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import model_metrics_key
    from bodywork_tpu_torch.train.trainer import METRIC_COLUMNS

    copy = FilesystemStore(shutil.copytree(store.root, os.path.join(workdir, "rejection")))
    production = resolve_alias(copy)
    model, _ = load_model(copy, production, device=dev)
    day = LOOP_START + timedelta(days=LOOP_DAYS)
    key = save_model(copy, model, day)
    copy.put_text(model_metrics_key(day), csv_record(
        METRIC_COLUMNS, {"date": day, "MAPE": 5.0, "r_squared": 0.05, "max_residual": 99.0}))
    register_candidate(copy, key, day=day)
    t0 = time.perf_counter()
    decision = ModelRegistry(copy, device=dev).gate(day=day)
    gate_seconds = time.perf_counter() - t0
    failed = [c["name"] for c in decision.checks if not c["ok"]]
    rows = [10.0, 50.0, 90.0]
    reset_launches()
    handle = serve_stage(StageContext(store=copy, today=day, device=dev),
                         buckets=[2048], replicas=2)
    try:
        health = handle.app.healthz_payload()
        got = torch.tensor(post(handle.url + "/batch", {"X": rows})["predictions"],
                           device=dev)
    finally:
        handle.stop()
    launches = dict(LAUNCHES)
    with torch.no_grad():
        want = mlp_apply(model.params, torch.tensor(rows, device=dev)[:, None])
    err = rel_err(got, want)[1]
    out = {"candidate": key, "promote": decision.promote, "failed_checks": failed,
           "min_r2": GatePolicy().min_r2, "gate_seconds": gate_seconds,
           "served_key": health["model_key"], "served_source": health["model_source"],
           "previous_production": production, "engine": health["engine"],
           "launches": launches, "err_over_scale_vs_plain": err}
    emit("day-loop-gate-rejection", **out)
    if decision.promote or "candidate-metrics" not in failed:
        raise RuntimeError(f"the failing candidate was not rejected by min_r2: {out}")
    if (health["model_key"], health["model_source"]) != (production, "production"):
        raise RuntimeError(f"the serve stage did not keep the previous production: {out}")
    if health["engine"] != "kernel" or launches["kernel"] < 2:
        raise RuntimeError(f"the previous production was not served by the kernel: {out}")
    if err >= BARS["kernel"] or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"the previous production's answers disagree: {err:.3g}")
    return out


def _card_against_cpu(torch, dev, store) -> dict:
    """Training on the card against the CPU, at width 1024 on the loop's
    history, from one init and one index stream: the first step's loss
    and gradients (the same params on both: no step amplifies a rounding
    difference) and the loss trajectory over 20 Adam steps, as largest
    relative gaps. The same with TF32 products on the card is the
    control: it must fail both step-0 bars, so that they tell IEEE
    float32 from TF32."""
    from bodywork_tpu_torch.data import load_all_datasets
    from bodywork_tpu_torch.device import matmul_precision
    from bodywork_tpu_torch.models.base import pad_rows
    from bodywork_tpu_torch.models.mlp import (
        MLPConfig,
        _loss,
        _scaled_splits,
        draw_indices,
        fit_keys,
        init_mlp_params,
        train_core,
    )

    cfg = MLPConfig(**{**LOOP_MLP, "n_steps": PARITY_STEPS})
    ds = load_all_datasets(store)
    arrays = [torch.as_tensor(a) for a in pad_rows(ds.X, ds.y)]
    k_init, k_train = fit_keys(11)
    net = init_mlp_params(k_init, WIDTHS)
    idx = draw_indices(k_train, PARITY_STEPS, cfg.batch_size, arrays[0].shape[0])

    def run(device):
        Xs, ys, _ = _scaled_splits(*(a.to(device) for a in arrays))
        w = arrays[2].to(device)
        on = {"layers": [{k: t.to(device) for k, t in layer.items()} for layer in net["layers"]]}
        leaves = [t.clone().requires_grad_(True) for layer in on["layers"] for t in layer.values()]
        shaped = {"layers": [dict(zip(layer, leaves[2 * i:2 * i + 2]))
                             for i, layer in enumerate(on["layers"])]}
        i0 = idx[0].to(device)
        loss0 = _loss(shaped, Xs[i0], ys[i0], w[i0])
        grads = torch.autograd.grad(loss0, leaves)
        _, losses = train_core(on, Xs, ys, w, idx.to(device), cfg)
        return losses.double().cpu(), [g.double().cpu() for g in grads]

    def gaps(got, want) -> dict:
        traj = ((got[0] - want[0]).abs() / want[0].abs()).tolist()
        return {"loss_step0": traj[0], "loss_max": max(traj), "loss_per_step": traj,
                "grad_step0": max(float((a - b).norm() / b.norm()) for a, b in zip(got[1], want[1]))}

    cpu = run(torch.device("cpu"))
    card = run(dev)
    measured = gaps(card, cpu)
    setting = matmul_precision()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = gaps(run(dev), cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    out = {"steps": PARITY_STEPS, "widths": list(WIDTHS), "batch_size": cfg.batch_size,
           "rows": int(arrays[0].shape[0]), "precision": setting,
           "loss_card": card[0].tolist(), "loss_cpu": cpu[0].tolist(),
           "max_rel_gap": measured["loss_max"], "gaps": measured, "bars": PARITY_BARS,
           "tf32_control": control}
    emit("day-loop-card-vs-cpu", **out)
    over = [k for k, bar in PARITY_BARS.items() if measured[k] >= bar]
    if over:
        raise RuntimeError(f"training on the card drifts from the CPU: {over}")
    if any(control[k] < bar for k, bar in PARITY_BARS.items()):
        raise RuntimeError(f"the step-0 bars do not refuse TF32 products: {control}")
    return out


def _train_profile(torch, dev, store) -> dict:
    """Where a training step's time goes on the card: PROFILE_STEPS Adam
    steps of the loop's MLP on its history, timed on the host clock
    (ending in a synchronize) without and then with ``torch.profiler``,
    whose kernel times give the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    from bodywork_tpu_torch.data import load_all_datasets
    from bodywork_tpu_torch.models.base import pad_rows
    from bodywork_tpu_torch.models.mlp import (
        MLPConfig,
        _scaled_splits,
        draw_indices,
        fit_keys,
        init_mlp_params,
        train_core,
    )

    cfg = MLPConfig(**{**LOOP_MLP, "n_steps": PROFILE_STEPS})
    ds = load_all_datasets(store)
    Xp, yp, w = (torch.as_tensor(a, device=dev) for a in pad_rows(ds.X, ds.y))
    Xs, ys, _ = _scaled_splits(Xp, yp, w)
    k_init, k_train = fit_keys(12)
    net = init_mlp_params(k_init, WIDTHS, device=dev)
    idx = draw_indices(k_train, PROFILE_STEPS, cfg.batch_size, Xp.shape[0], device=dev)

    def window() -> float:
        t0 = time.perf_counter()
        train_core(net, Xs, ys, w, idx, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    window()  # warm-up
    wall_s = window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = window()
    # the kernels' own rows: an operator's row also carries its kernels' time
    kernels = [r for r in prof.key_averages()
               if r.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(float(r.self_device_time_total) for r in kernels)
    top = sorted(kernels, key=lambda r: r.self_device_time_total, reverse=True)[:6]
    return {
        "steps": PROFILE_STEPS, "ms_per_step": 1e3 * wall_s / PROFILE_STEPS,
        "profiled_ms_per_step": 1e3 * profiled_s / PROFILE_STEPS,
        "device_ms_per_step": busy_us / 1e3 / PROFILE_STEPS if busy_us else "not measured",
        # of the profiled window, and of an unprofiled step (the profiler
        # slows the host, not the kernels)
        "device_busy_share": busy_us / 1e6 / profiled_s if busy_us else "not measured",
        "device_share_of_unprofiled_step": busy_us / 1e6 / wall_s if busy_us else "not measured",
        "kernels_per_step": sum(r.count for r in kernels) / PROFILE_STEPS,
        "top_kernels_ms_per_step": {
            r.key[:70]: float(r.self_device_time_total) / 1e3 / PROFILE_STEPS for r in top},
    }


def phase_mlp_draws(torch, dev) -> dict:
    """The seeded MLP fit's threefry draws on the card against the CPU:
    the 2000-step minibatch index stream (batch 256) over the 7-day
    loop's padded rows and over a row count that is not a power of two,
    and the 1024-wide He init, all bit-equal; with the card's times (the
    host walk of the key chain inside the index draw, timed alone too)."""
    from bodywork_tpu_torch.data import prng
    from bodywork_tpu_torch.models.mlp import draw_indices, fit_keys, init_mlp_params

    k_init, k_train = fit_keys(0)
    steps, batch = LOOP_MLP["n_steps"], LOOP_MLP["batch_size"]
    cpu = torch.device("cpu")
    equal = {}
    for rows in DRAW_ROWS:
        card = draw_indices(k_train, steps, batch, rows, device=dev).cpu()
        host = draw_indices(k_train, steps, batch, rows, device=cpu)
        equal[rows] = bool(torch.equal(card, host)) and card.shape == (steps, batch)
    card_net = init_mlp_params(k_init, WIDTHS, device=dev)
    host_net = init_mlp_params(k_init, WIDTHS, device=cpu)
    init_equal = all(
        torch.equal(a[k].cpu().view(torch.int32), b[k].view(torch.int32))
        for a, b in zip(card_net["layers"], host_net["layers"]) for k in ("w", "b"))

    def timed_ms(fn) -> float:
        times = []
        for _ in range(DRAW_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    out = {"steps": steps, "batch": batch, "rows": list(DRAW_ROWS),
           "indices_bit_equal": equal, "init_widths": list(WIDTHS),
           "init_bit_equal": init_equal, "reps": DRAW_REPS,
           "draw_indices_ms": timed_ms(
               lambda: draw_indices(k_train, steps, batch, DRAW_ROWS[0], device=dev)),
           "key_chain_host_ms": timed_ms(lambda: prng.key_chain(k_train, steps)),
           "init_ms": timed_ms(lambda: init_mlp_params(k_init, WIDTHS, device=dev))}
    emit("mlp-draws", **out)
    if not all(equal.values()) or not init_equal:
        raise RuntimeError(f"the card's MLP draws differ from the CPU's: {out}")
    return out


def _linear_refit_gap(store, doc) -> dict:
    """The trainstate's solution against an independent float64 refit
    (``np.linalg.lstsq``) over the union of the covered days' train
    splits (``bench.py:2548``, ``_linear_coefficient_check``)."""
    import numpy as np

    from bodywork_tpu_torch.data.io import load_dataset
    from bodywork_tpu_torch.models.linear import solve_normal_eq
    from bodywork_tpu_torch.store.schema import DATASETS_PREFIX
    from bodywork_tpu_torch.train.incremental import day_split_indices

    split = doc["split"]
    Xs, ys = [], []
    for key, d in store.history(DATASETS_PREFIX):
        if str(d) not in doc["days"]:
            continue
        ds = load_dataset(store, key)
        train_idx, _ = day_split_indices(len(ds), d, split["test_size"], split["seed"])
        Xs.append(np.asarray(ds.X, np.float64)[train_idx])
        ys.append(np.asarray(ds.y, np.float64)[train_idx])
    X, y = np.concatenate(Xs), np.concatenate(ys)
    theta = np.linalg.lstsq(np.concatenate([X, np.ones((len(y), 1))], axis=1), y,
                            rcond=None)[0]
    host = solve_normal_eq(doc["cum_g"], doc["cum_c"])
    got = np.concatenate([np.asarray(host["w"], np.float64).ravel(), [float(host["b"])]])
    return {"days": len(doc["days"]), "rows": int(len(y)), "coefficients": got.tolist(),
            "refit": theta.tolist(), "max_abs_gap": float(np.max(np.abs(got - theta))),
            "atol": REFIT_ATOL}


def _incremental_linear(torch, dev, workdir: str) -> dict:
    """(a) The linear loop on the card for INC_LINEAR_DAYS days in
    ``mode="incremental"`` (day 1 builds the trainstate): the per-day
    train seconds and their last-third over first-third ratio over days
    2 on, the final coefficients against a float64 refit, and the
    trainstate bytes against the same days folded on the CPU."""
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, trainstate_key
    from bodywork_tpu_torch.train import train_on_history
    from bodywork_tpu_torch.train.incremental import read_trainstate

    loop = _run_loop(torch, dev, workdir, "linear", {"mode": "incremental"},
                     n_days=INC_LINEAR_DAYS, line="incremental-day")
    store = loop["runner"].store
    train_s = [r.stage_seconds[TRAIN_STAGE] for r in loop["results"]]
    # day 1 apart: it builds the trainstate and carries the process's
    # first use of the card's solver and copies (PERF.md section 2)
    steady = train_s[1:]
    third = len(steady) // 3
    doc, _token, reason = read_trainstate(store, "linear")
    gap = _linear_refit_gap(store, doc)
    # the same days folded one by one on the CPU, from the card's datasets
    cpu_store = FilesystemStore(os.path.join(workdir, "linear-incremental-cpu"))
    for key, d in store.history(DATASETS_PREFIX):
        if str(d) in doc["days"]:
            cpu_store.put_bytes(key, store.get_bytes(key))
            train_on_history(cpu_store, "linear", mode="incremental", device="cpu")
    key = trainstate_key("linear")
    out = {"days": INC_LINEAR_DAYS, "train_seconds": train_s, "day1_train_s": train_s[0],
           "last_third_over_first_third_days_2_on": (statistics.mean(steady[-third:])
                                                     / statistics.mean(steady[:third])),
           "median_train_s_days_2_on": statistics.median(steady),
           "modes": [d["train_mode"] for d in loop["days"]],
           "fallback_reasons": [d["fallback_reason"] for d in loop["days"]],
           "rows_touched": [d["rows_touched"] for d in loop["days"]],
           "gate_verdicts": [d["gate"]["promote"] for d in loop["days"]],
           "trainstate_reason": reason, "coefficient_check": gap,
           "trainstate_bytes": len(store.get_bytes(key)),
           "trainstate_equal_to_cpu": store.get_bytes(key) == cpu_store.get_bytes(key),
           "wall_clock_s": loop["summary"]["wall_clock_s"],
           "prefetched": loop["summary"]["prefetched"],
           "lookaheads_collected": loop["summary"]["lookaheads_collected"],
           "runs_through": loop["summary"]["runs_through"]}
    emit("incremental-linear", **out)
    if reason is not None or gap["max_abs_gap"] >= REFIT_ATOL:
        raise RuntimeError(f"the incremental linear solution is off the refit: {gap}")
    if not out["trainstate_equal_to_cpu"]:
        raise RuntimeError("the card's trainstate differs from the CPU's for the same days")
    if set(out["modes"]) != {"incremental"} or out["fallback_reasons"][1:] != \
            [None] * (INC_LINEAR_DAYS - 1):
        raise RuntimeError(f"the linear loop did not fold incrementally: {out}")
    return {**out, "store": store}


def _incremental_mlp(torch, dev, workdir: str) -> dict:
    """(b) The 1024-wide MLP loop for LOOP_DAYS days in ``mode=
    "incremental"``: day 1 a full refit (no donor yet), days 2-5
    fine-tunes of production (a quarter of the steps), each gated with
    shadow evaluation, production served through ``kernel``."""
    loop = _run_loop(torch, dev, workdir, "mlp", {**LOOP_MLP, "mode": "incremental"},
                     line="incremental-day")
    days = loop["days"]
    summary = {**loop["summary"],
               "modes": [d["train_mode"] for d in days],
               "fallback_reasons": [d["fallback_reason"] for d in days],
               "train_seconds": [r.stage_seconds["stage-1-train-model"]
                                 for r in loop["results"]]}
    emit("incremental-mlp", **summary)
    # day 1 has no donor; every later day fine-tunes, or refits in full
    # after the gate rejected its fine-tune
    later = list(zip(summary["modes"], summary["fallback_reasons"]))[1:]
    if days[0]["fallback_reason"] != "no_donor" or any(
            d not in (("incremental", None), ("full", "gate_rejected")) for d in later):
        raise RuntimeError(f"the MLP loop did not train incrementally: {summary}")
    bad = [d["day"] for d in days if d["engine"] != "kernel" or d["launches"] < 1]
    if bad:
        raise RuntimeError(f"the incremental MLP loop did not serve through the kernel on {bad}")
    return {"summary": summary, "runner": loop["runner"]}


def _incremental_rejection(torch, dev, store, workdir: str) -> dict:
    """(c) On a copy of (b)'s store, day 8 with a fine-tune made to fail
    (it trains on all-zero labels): the gate rejects the incremental
    candidate, the runner refits in full the same day
    (``fallback_reason="gate_rejected"``), gates the refit and serves it
    through ``kernel`` (launches counted over the day)."""
    from bodywork_tpu_torch.models.mlp import MLPRegressor
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import SERVE_STAGE, TRAIN_STAGE
    from bodywork_tpu_torch.registry.records import load_record
    from bodywork_tpu_torch.store import FilesystemStore

    copy = FilesystemStore(shutil.copytree(store.root, os.path.join(workdir, "inc-rejection")))
    spec = default_pipeline("mlp", "batch")
    spec.stages[TRAIN_STAGE].args.update({**LOOP_MLP, "mode": "incremental"})
    day = LOOP_START + timedelta(days=LOOP_DAYS)
    real = MLPRegressor.fine_tune

    def failing_fine_tune(self, X, y, n_steps, seed=None):
        return real(self, X, torch.zeros(len(y)).numpy(), n_steps, seed=seed)

    MLPRegressor.fine_tune = failing_fine_tune
    try:
        reset_launches()
        r = LocalRunner(spec, copy, device=dev).run_day(day)
        launches = dict(LAUNCHES)
    finally:
        MLPRegressor.fine_tune = real
    line = _day_line("mlp", r, launches["kernel"])
    final = r.stage_results[TRAIN_STAGE]
    history = [e["event"] for e in load_record(copy, final.model_artefact_key)["history"]]
    out = {**line, "record_events": history, "launches_all": launches}
    emit("incremental-gate-rejection", **out)
    served = r.stage_results[SERVE_STAGE].app.healthz_payload()
    if (final.mode, final.fallback_reason) != ("full", "gate_rejected"):
        raise RuntimeError(f"no same-day full refit after the rejection: {out}")
    if "gate_decision" not in history[:-1] or history[-1] != "promoted":
        raise RuntimeError(f"the refit was not re-gated and promoted: {history}")
    if served["model_key"] != final.model_artefact_key or launches["kernel"] < 1:
        raise RuntimeError(f"the refit was not served through the kernel: {out}")
    return out


def phase_incremental(torch, dev, workdir: str) -> dict:
    linear = _incremental_linear(torch, dev, workdir)
    snapshot = _cold_snapshot_train(torch, dev, linear.pop("store"), workdir)
    mlp = _incremental_mlp(torch, dev, workdir)
    rejection = _incremental_rejection(torch, dev, mlp["runner"].store, workdir)
    return {"linear": linear, "mlp": mlp["summary"], "rejection": rejection,
            "snapshot": snapshot, "store": mlp["runner"].store}


#: ``python -c`` driver of the cli that prints the process's
#: ``bodywork_tpu_runner_resumes_total`` series to stderr each time the
#: runner counts one, so a process the kill switch ends still reports it
_RESUME_PROBE = """
import sys
from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.pipeline import journal
real = journal.count_resume
def count_resume(outcome):
    real(outcome)
    for line in get_registry().render().splitlines():
        if line.startswith("bodywork_tpu_runner_resumes_total{"):
            print("RESUMES " + line, file=sys.stderr, flush=True)
journal.count_resume = count_resume
from bodywork_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""


def _cli(args: list, env: dict | None = None, timeout: float = 300,
         count_resumes: bool = False) -> dict:
    """``python -m bodywork_tpu_torch.cli ARGS`` from the checkout: its
    exit code, output and seconds; with ``count_resumes``, also the
    ``runner_resumes_total`` samples the process counted (``resumes``:
    outcome -> value at its last count)."""
    import re

    t0 = time.perf_counter()
    cmd = ["-c", _RESUME_PROBE] if count_resumes else ["-m", "bodywork_tpu_torch.cli"]
    proc = subprocess.run(
        [sys.executable, *cmd, *args], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT, **(env or {})},
        capture_output=True, text=True, timeout=timeout,
    )
    out = {"rc": proc.returncode, "out": proc.stdout, "err": proc.stderr,
           "seconds": time.perf_counter() - t0}
    if count_resumes:
        out["resumes"] = {m[1]: float(m[2]) for m in re.finditer(
            r'^RESUMES bodywork_tpu_runner_resumes_total\{outcome="(\w+)"\} (\S+)$',
            proc.stderr, re.M)}
    return out


def _mlp_day_args(store: str, day: date, mlp: dict = SOAK_MLP) -> list:
    """``run-day`` of the 1024-wide MLP day (the loop's settings, its fit
    at ``mlp``'s Adam steps)."""
    return ["run-day", "--store", store, "--date", str(day), "--model", "mlp",
            "--mlp-hidden", ",".join(map(str, HIDDEN)),
            "--mlp-steps", str(mlp["n_steps"]), "--mlp-lr", str(mlp["learning_rate"])]


def _served(out: str) -> dict | None:
    """The ``served:`` line of a ``run-day`` day: key, source, engine and
    the served kernel's launches in that process, with the next line's
    launches of every kernel in that process."""
    import re

    m = re.search(r"served: (\S+) \((\w+)\) on (\S+), (\d+) kernel launches", out)
    by_kernel = re.search(r"launches by kernel in this process: (\{.*\})$", out, re.M)
    if m is None or by_kernel is None:
        return None
    return {"model_key": m[1], "model_source": m[2], "engine": m[3],
            "launches": int(m[4]), "launches_by_kernel": json.loads(by_kernel[1])}


def _day_seconds(out: str, day: date) -> float | None:
    import re

    m = re.search(rf"^day {day}: ([0-9.]+)s$", out, re.M)
    return None if m is None else float(m[1])


def _rehash_seconds(store, day: date) -> tuple[float, int]:
    """Seconds to re-hash every artefact the day's journal recorded (the
    digest check a resume makes), and the bytes hashed."""
    from bodywork_tpu_torch.pipeline.journal import artefact_digest
    from bodywork_tpu_torch.store.schema import run_journal_key

    doc = json.loads(store.get_bytes(run_journal_key(day)))
    keys = [k for e in doc["stages"].values() for k in (e.get("artefacts") or {})]
    t0 = time.perf_counter()
    n = 0
    for key in keys:
        data = store.get_bytes(key)
        n += len(data)
        artefact_digest(data)
    return time.perf_counter() - t0, n


def _journal_day_seconds(store, day: date) -> float:
    """Seconds of one fresh day's journal writes on this machine's disk:
    acquire, the intent and complete marks of the default pipeline's four
    steps (the service's step records no complete) and the closing write."""
    from bodywork_tpu_torch.pipeline.journal import RunJournal, artefact_digest

    t0 = time.perf_counter()
    j = RunJournal(store, day, owner="timing", lease_ttl_s=60)
    j.acquire()
    for stage, done in (("train", True), ("serve", False), ("generate", True), ("test", True)):
        j.record_intents([stage])
        if done:
            j.record_completes({stage: {"k": artefact_digest(b"x")}})
    j.record_day_complete()
    return time.perf_counter() - t0


def phase_resume(torch, dev, workdir: str) -> dict:
    """A killed MLP day (width 1024, full mode) resumed through the
    command line: ``run-day`` killed by the kill switch at the step
    boundary after train (so the gate ran and serve did not) exits
    ``EXIT_KILLED``; the restart exits 0, skips train on the journal's
    digests and serves ``production`` through ``kernel``; a third run is a
    no-op (6); a live foreign lease exits 5. Every artefact is
    byte-identical to an uncrashed twin day run in this process, the
    checkpoint being the killed run's own, re-verified and not rewritten."""
    from bodywork_tpu_torch.chaos.kill import ENV_SCHEDULE, EXIT_KILLED
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.journal import (
        LEASE_LOST_EXIT,
        RESUMED_NOOP_EXIT,
        RunJournal,
        artefact_digest,
    )
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
    from bodywork_tpu_torch.store import FilesystemStore, open_store
    from bodywork_tpu_torch.store.schema import model_key, run_journal_key

    spec = default_pipeline("mlp", "batch")
    spec.stages[TRAIN_STAGE].args.update(SOAK_MLP)
    day = LOOP_START
    # audited stores, as the command line opens them: both sides carry
    # the write-time digest sidecars
    twin = LocalRunner(spec, open_store(os.path.join(workdir, "twin")), device=dev)
    twin.bootstrap(day)
    reset_launches()
    full = twin.run_day(day)
    twin_launches = dict(LAUNCHES)
    root = os.path.join(workdir, "resumed")
    store = FilesystemStore(root)
    LocalRunner(spec, open_store(root), device=dev).bootstrap(day)
    args = _mlp_day_args(root, day)
    ttl = {"BODYWORK_TPU_RUN_LEASE_TTL_S": "1"}
    killed = _cli(args, {**ttl, ENV_SCHEDULE: '[{"kind": "stage_boundary", "n": 1}]'},
                  count_resumes=True)
    doc = json.loads(store.get_bytes(run_journal_key(day)))
    ckpt = model_key(day)
    killed_digest = artefact_digest(store.get_bytes(ckpt))
    time.sleep(1.5)  # the killed runner's lease expires
    resumed = _cli(args, ttl, count_resumes=True)
    noop = _cli(args, ttl, count_resumes=True)
    RunJournal(store, day + timedelta(days=1), owner="foreign:1:live",
               lease_ttl_s=900).acquire()
    leased = _cli(_mlp_day_args(root, day + timedelta(days=1)), ttl)
    served = _served(resumed["out"])
    twin_results = _results_of(os.path.join(workdir, "twin"))
    resumed_results = _results_of(root)
    gap = _compare_results(twin_results, resumed_results)
    rehash_s, rehash_bytes = _rehash_seconds(store, day)
    counted = [killed["resumes"], resumed["resumes"], noop["resumes"]]
    out = {
        "day": str(day), "twin_day_s": full.wall_clock_s, "twin_launches": twin_launches,
        "runner_resumes_total": counted,
        "killed": {"rc": killed["rc"], "want": EXIT_KILLED, "process_s": killed["seconds"],
                   "journal_train_state": doc["stages"].get(TRAIN_STAGE, {}).get("state"),
                   "journal_status": doc["status"]},
        "resumed": {"rc": resumed["rc"], "process_s": resumed["seconds"],
                    "day_s": _day_seconds(resumed["out"], day),
                    "skipped_train": f"skipped {TRAIN_STAGE} (journal-verified)" in resumed["out"],
                    "served": served},
        "noop": {"rc": noop["rc"], "want": RESUMED_NOOP_EXIT, "process_s": noop["seconds"]},
        "lease_lost": {"rc": leased["rc"], "want": LEASE_LOST_EXIT,
                       "process_s": leased["seconds"]},
        "checkpoint": {"key": ckpt, "killed_run_digest": killed_digest,
                       "after_resume_digest": artefact_digest(store.get_bytes(ckpt)),
                       "twin_digest": artefact_digest(twin.store.get_bytes(ckpt))},
        "byte_identity_vs_twin": gap,
        "digests_resumed_vs_twin": {
            key: [artefact_digest(data)[7:23], artefact_digest(twin_results[key])[7:23]]
            for key, data in resumed_results.items() if key in twin_results},
        "resume_rehash_s": rehash_s, "resume_rehash_bytes": rehash_bytes,
        "journal_writes_day_s": _journal_day_seconds(
            FilesystemStore(os.path.join(workdir, "journal-timing")), day),
    }
    emit("resume", **out)
    if (killed["rc"], resumed["rc"], noop["rc"], leased["rc"]) != (
            EXIT_KILLED, 0, RESUMED_NOOP_EXIT, LEASE_LOST_EXIT):
        raise RuntimeError(f"resume exit codes are off: {out}\n{resumed['err'][-3000:]}")
    if counted != [{"fresh": 1.0}, {"resumed": 1.0}, {"noop": 1.0}]:
        raise RuntimeError(f"runner_resumes_total over the killed, restarted and no-op "
                           f"days is not fresh, resumed, noop: {counted}")
    if out["killed"]["journal_train_state"] != "complete" or not out["resumed"]["skipped_train"]:
        raise RuntimeError(f"the restart did not skip the journalled train stage: {out}")
    if (served is None or served["engine"] != "kernel" or served["launches"] < 1
            or served["model_source"] != "production" or served["model_key"] != ckpt):
        raise RuntimeError(f"the resumed day did not serve production through kernel: {out}")
    if out["checkpoint"]["after_resume_digest"] != killed_digest:
        raise RuntimeError(f"the resume rewrote the killed run's checkpoint: {out}")
    differ = [k for k in gap["differ"] if k != ckpt]
    if differ or gap["only_in_first"] or gap["only_in_second"]:
        raise RuntimeError(f"the resumed day's artefacts differ from the twin's: {gap}")
    return {"launches": served["launches_by_kernel"], "twin_launches": twin_launches}


def phase_sigterm(torch, dev, workdir: str) -> dict:
    """SIGTERM to a 1024-wide MLP ``run-day`` while it trains: it exits
    143 with the journal ``interrupted`` and the lease released, and the
    next ``run-day`` resumes the day (exit 0)."""
    import signal

    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import run_journal_key
    from bodywork_tpu_torch.utils.shutdown import SIGTERM_EXIT

    spec = default_pipeline("mlp", "batch")
    day = LOOP_START
    root = os.path.join(workdir, "sigterm")
    store = FilesystemStore(root)
    LocalRunner(spec, store, device=dev).bootstrap(day)
    key = run_journal_key(day)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "bodywork_tpu_torch.cli",
                             *_mlp_day_args(root, day, LOOP_MLP)], cwd=ROOT,
                            env={**os.environ, "PYTHONPATH": ROOT},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while time.perf_counter() - t0 < 240 and proc.poll() is None:
            if store.exists(key) and json.loads(store.get_bytes(key))["stages"].get(
                    TRAIN_STAGE, {}).get("state") == "intent":
                break
            time.sleep(0.05)
        time.sleep(1.0)  # into the Adam loop
        signalled_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    doc = json.loads(store.get_bytes(key))
    restart = _cli(_mlp_day_args(root, day, LOOP_MLP))
    after = json.loads(store.get_bytes(key))
    line = {"rc": proc.returncode, "want": SIGTERM_EXIT, "signalled_after_s": signalled_s,
            "process_s": time.perf_counter() - t0 - restart["seconds"],
            "journal_status": doc["status"], "lease_owner": doc["lease"]["owner"],
            "train_state": doc["stages"].get(TRAIN_STAGE, {}).get("state"),
            "restart_rc": restart["rc"], "restart_process_s": restart["seconds"],
            "restart_day_s": _day_seconds(restart["out"], day),
            "restart_served": _served(restart["out"]), "final_status": after["status"]}
    emit("sigterm", **line)
    if (proc.returncode, doc["status"], doc["lease"]["owner"], line["train_state"]) != (
            SIGTERM_EXIT, "interrupted", None, "intent"):
        raise RuntimeError(f"SIGTERM mid-train was not a clean interruption: {line}\n"
                           f"{err[-3000:]}")
    served = line["restart_served"]
    if restart["rc"] != 0 or after["status"] != "complete" or served is None \
            or served["engine"] != "kernel" or served["launches"] < 1:
        raise RuntimeError(f"the day did not resume after SIGTERM and serve through "
                           f"kernel: {line}\n{restart['err'][-3000:]}")
    return {"launches": served["launches_by_kernel"]}


def phase_day_report(torch, dev, workdir: str) -> dict:
    """``day-report``: one ``cli run-day`` of the 1024-wide MLP on a fresh
    store with ``--trace-out`` and ``--report-out`` (``{date}`` in both),
    served by ``kernel``: the report's schema, every stage span's Chrome
    trace duration equal to the report's ``stage_seconds`` (to the
    report's 1e-6 s rounding), the ``registry-gate`` and ``run-day-<date>``
    spans present; the gate's seconds and the day's seconds outside every
    stage and gate span (the journal's writes and the artefact digests
    recorded for them, the kill points, the services' stop) printed."""
    day = LOOP_START
    root = os.path.join(workdir, "day-report")
    out_dir = os.path.join(workdir, "day-report-out")
    res = _cli(_mlp_day_args(root, day) + [
        "--trace-out", os.path.join(out_dir, "{date}.trace.json"),
        "--report-out", os.path.join(out_dir, "{date}.report.json")])
    if res["rc"] != 0:
        raise RuntimeError(f"run-day with --trace-out failed: {res['err'][-3000:]}")
    with open(os.path.join(out_dir, f"{day}.report.json")) as f:
        report = json.load(f)
    with open(os.path.join(out_dir, f"{day}.trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    dur = {e["name"]: e["dur"] for e in events}
    day_span = f"run-day-{day}"
    stage_us = {name: dur.get(name) for name in report["stage_seconds"]}
    gap_us = {name: None if us is None else abs(us - 1e6 * report["stage_seconds"][name])
              for name, us in stage_us.items()}
    served = _served(res["out"])
    outside_s = (dur.get(day_span, 0.0) - sum(v or 0.0 for v in stage_us.values())
                 - dur.get("registry-gate", 0.0)) / 1e6
    out = {"day": str(day), "rc": res["rc"], "process_s": res["seconds"],
           "schema": report["schema"], "stage_seconds": report["stage_seconds"],
           "trace_stage_us": stage_us, "max_gap_us": max(
               (g for g in gap_us.values() if g is not None), default=None),
           "spans": [(e["name"], e["cat"]) for e in events],
           "gate_s": dur.get("registry-gate", 0.0) / 1e6,
           "day_s": dur.get(day_span, 0.0) / 1e6,
           "bootstrap_s": dur.get(f"bootstrap-{day}", 0.0) / 1e6,
           "outside_stage_and_gate_spans_s": outside_s,
           "served": served}
    emit("day-report", **out)
    if report["schema"] != "bodywork_tpu.day_report/1" or None in gap_us.values() \
            or max(gap_us.values()) > 0.5 + 1e-3:
        raise RuntimeError(f"the day report and its trace disagree: {out}")
    if "registry-gate" not in dur or day_span not in dur:
        raise RuntimeError(f"the gate or the day span is missing: {out}")
    if served is None or served["engine"] != "kernel" or served["launches"] < 1:
        raise RuntimeError(f"the reported day did not serve through kernel: {out}")
    return {"launches": served["launches_by_kernel"]}


def _kernel_events(path: str) -> dict:
    """What a torch.profiler Chrome trace holds: device events by
    category, the f32 kernel's events by name, and the graph launches;
    by correlation id, the f32 kernels' and the graph launches', and for
    each graph launch whose kernel the trace names, the kernel's
    timestamp less the launch's (us)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device_cats = ("kernel", "gpu_memcpy", "gpu_memset")
    device = [e for e in events if e.get("cat") in device_cats]
    f32 = [e for e in device if "mlp_f32_kernel" in e.get("name", "")]
    graph = [e for e in events if e.get("name") == "cudaGraphLaunch"]
    f32_at = {(e.get("args") or {}).get("correlation"): e["ts"] for e in f32}
    graph_at = {(e.get("args") or {}).get("correlation"): e["ts"] for e in graph}
    launches = sorted(c for c in graph_at if c is not None)
    return {
        "events": len(events),
        "device_events": {c: sum(e.get("cat") == c for e in device) for c in device_cats},
        "f32_kernel_named": len(f32),
        "graph_launches": len(graph),
        "f32_kernel_correlations": sorted(c for c in f32_at if c is not None),
        "graph_launch_correlations": launches,
        "graph_kernel_skew_us": [round(f32_at[c] - graph_at[c], 1) for c in launches
                                 if c in f32_at],
    }


_AUDIT_PROBE = """
import atexit, json, sys, time, zlib
from bodywork_tpu_torch.audit import manifest
spent = {}
def _add(key, what, seconds):
    entry = spent.setdefault(key.split("/", 1)[0] + "/", {})
    entry[what] = entry.get(what, 0.0) + seconds
real_write = manifest.write_sidecar
def write_sidecar(store, key, data):
    t0 = time.perf_counter()
    try:
        return real_write(store, key, data)
    finally:
        _add(key, "sidecar_s", time.perf_counter() - t0)
        _add(key, "bytes", len(data))
real_compress = zlib.compress
class _Zlib:
    error = zlib.error
    decompress = staticmethod(zlib.decompress)
    @staticmethod
    def compress(data, level):
        t0 = time.perf_counter()
        try:
            return real_compress(data, level)
        finally:
            spent.setdefault("zlib", {"seconds": 0.0})["seconds"] += time.perf_counter() - t0
manifest.write_sidecar = write_sidecar
manifest.zlib = _Zlib
atexit.register(lambda: print("SIDECARS " + json.dumps(spent), file=sys.stderr, flush=True))
from bodywork_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""


def phase_audit(torch, dev, workdir: str) -> dict:
    """``audit``: two 1024-wide MLP days through ``cli run-day --scrub``,
    each in a process of its own on the card (the soaks' settings, served
    by ``kernel``), writing through the audited store the command line
    opens: every day's ``fsck:`` line must read ``clean``. Printed: the
    sidecars by class, the seconds each process spent writing sidecars by
    the primary's prefix (the train stage writes ``models/`` and
    ``model-metrics/``) with the replicas' zlib apart, each day's
    wall-clock and train stage. Then the port's ``run_fsck`` and the JAX
    package's ``cli fsck --json`` (a subprocess on the CPU: its fsck
    imports no accelerator runtime) must both report the store clean with
    0 findings."""
    import re

    from bodywork_tpu_torch.audit import run_fsck
    from bodywork_tpu_torch.store import open_store

    root = os.path.join(workdir, "audit")
    days, launches = [], {}
    for i in range(AUDIT_DAYS):
        day = LOOP_START + timedelta(days=i)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _AUDIT_PROBE, *_mlp_day_args(root, day), "--scrub"],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
            text=True, timeout=300)
        seconds = time.perf_counter() - t0
        served = _served(proc.stdout)
        fsck_line = re.search(r"^fsck: (.*)$", proc.stdout, re.M)
        train = re.search(r"^  stage-1-train-model: ([0-9.]+)s$", proc.stdout, re.M)
        sidecars = re.search(r"^SIDECARS (\{.*\})$", proc.stderr, re.M)
        row = {"day": str(day), "rc": proc.returncode, "process_s": seconds,
               "day_s": _day_seconds(proc.stdout, day),
               "train_stage_s": float(train[1]) if train else None,
               "fsck": fsck_line[1] if fsck_line else None,
               "sidecar_seconds": json.loads(sidecars[1]) if sidecars else None,
               "served": served}
        days.append(row)
        emit("audit-day", **row)
        if (proc.returncode != 0 or row["fsck"] != "clean" or served is None
                or served["engine"] != "kernel" or served["launches"] < 1 or sidecars is None):
            raise RuntimeError(f"audit: day {day}: {row}\n{proc.stderr[-3000:]}")
        for name, n in served["launches_by_kernel"].items():
            launches[name] = launches.get(name, 0) + n
    store = open_store(root)
    by_class = {}
    for key in store.list_keys("audit/digests/"):
        cls = key[len("audit/digests/"):].split("/", 1)[0] + "/"
        by_class[cls] = by_class.get(cls, 0) + 1
    t0 = time.perf_counter()
    port_report = run_fsck(store)
    port_s = time.perf_counter() - t0
    jax_fsck = subprocess.run(
        [sys.executable, "-m", "bodywork_tpu.cli", "fsck", "--store", root, "--json"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300)
    try:
        jax_report = json.loads(jax_fsck.stdout)
    except ValueError:
        jax_report = None
    out = {"days": days, "sidecars_by_class": by_class,
           "port_fsck": {"clean": port_report["clean"], "findings": len(port_report["findings"]),
                         "keys_scanned": port_report["keys_scanned"], "seconds": port_s},
           "jax_fsck": {"rc": jax_fsck.returncode,
                        "clean": jax_report and jax_report["clean"],
                        "findings": None if jax_report is None else len(jax_report["findings"]),
                        "keys_scanned": jax_report and jax_report["keys_scanned"]},
           "launches": launches}
    emit("audit", **out)
    if (not port_report["clean"] or port_report["findings"] or jax_report is None
            or jax_fsck.returncode != 0 or not jax_report["clean"] or jax_report["findings"]
            or jax_report["keys_scanned"] != port_report["keys_scanned"]):
        raise RuntimeError(f"audit: the card-written store is not clean to both packages' "
                           f"fsck: {out}\n{jax_fsck.stderr[-3000:]}")
    return out


def _by_prefix_verdict(root: str, comparison: dict, extra_excluded: tuple = ()) -> dict:
    """The compared keys of a soak's healthy twin by top-level prefix, each
    with its verdict (no key missing, extra or mismatched there)."""
    from bodywork_tpu_torch.chaos.sim import _COMPARE_EXCLUDED
    from bodywork_tpu_torch.store import FilesystemStore

    bad = set(comparison["missing"]) | set(comparison["extra"]) | set(comparison["mismatched"])
    out = {}
    for key in FilesystemStore(root).list_keys():
        if key.startswith(_COMPARE_EXCLUDED + tuple(extra_excluded)):
            continue
        prefix = key.split("/", 1)[0] + "/"
        if prefix == "audit/":
            prefix = "audit/" + key.split("/")[2] + "/"
        entry = out.setdefault(prefix, {"keys": 0, "identical": True})
        entry["keys"] += 1
        entry["identical"] &= key not in bad
    return out


def phase_chaos_sim(torch, dev, workdir: str) -> dict:
    """``chaos-sim``: ``run_chaos_sim`` over 3 days of the 1024-wide MLP
    (its fits cut to 200 Adam steps), the stock fault plan, seed 0, both
    twins on the card: the faulted twin over the fault-injecting,
    retrying, breaker-guarded store and the flaky scoring service, served
    by ``kernel``. Every final artefact must be byte-identical to the
    fault-free twin's (the verdict per prefix printed), with the injected
    faults and the retries by kind, the breaker's opens, each twin's
    seconds, and ``kernel``'s launches over both twins (> 0)."""
    from bodywork_tpu_torch.chaos import FaultPlan, run_chaos_sim
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches

    root = os.path.join(workdir, "chaos")
    reset_launches()
    summary = run_chaos_sim(root, LOOP_START, SOAK_DAYS, FaultPlan.default(0),
                            model_type="mlp", device=dev, model_kwargs=SOAK_MLP)
    launches = dict(LAUNCHES)
    comparison = summary["comparison"]
    out = {"days": SOAK_DAYS, "seed": summary["seed"], "ok": summary["ok"],
           "reduced": _SOAK_REDUCED,
           "matched": comparison["matched"], "torn": comparison["torn"],
           "snapshot_ok": comparison["snapshot_ok"], "journal_ok": comparison["journal_ok"],
           "by_prefix": _by_prefix_verdict(os.path.join(root, "baseline"), comparison),
           "faults_injected": summary["faults_injected"], "retries": summary["retries"],
           "breaker_state": summary["breaker_state"], "breaker_opens": summary["breaker_opens"],
           "seconds": summary["seconds"], "launches": launches}
    emit("chaos-sim", **out)
    if not summary["ok"] or launches["kernel"] < 1:
        raise RuntimeError(f"chaos-sim: {out} {comparison}")
    return out


def phase_bit_rot(torch, dev, workdir: str) -> dict:
    """``bit-rot``: ``run_bit_rot_sim`` over 3 days of the 1024-wide MLP
    (fits cut to 200 steps) on the card, the stock plan with bit rot at
    0.25, seed 0: the flips by prefix, the share of them fsck detected and
    classified (100% required), the repairs by action and outcome, and the
    victim byte-identical to the healthy twin outside ``quarantine/``
    after the repair; each twin's and each scrub's seconds; ``kernel``'s
    launches over both twins (> 0)."""
    from bodywork_tpu_torch.chaos import FaultPlan, run_bit_rot_sim
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches

    plan = FaultPlan.default(0)
    plan.bit_rot_p = 0.25
    root = os.path.join(workdir, "bitrot")
    reset_launches()
    summary = run_bit_rot_sim(root, LOOP_START, SOAK_DAYS, plan, model_type="mlp",
                              device=dev, model_kwargs=SOAK_MLP)
    launches = dict(LAUNCHES)
    repairs = {}
    for r in summary["repairs"]:
        label = f"{r['action']}:{r['outcome']}"
        repairs[label] = repairs.get(label, 0) + 1
    out = {"days": SOAK_DAYS, "seed": summary["seed"], "ok": summary["ok"],
           "reduced": _SOAK_REDUCED,
           "injected": summary["injected"], "injected_by_prefix": summary["injected_by_prefix"],
           "detected": summary["detected"],
           "detected_share": summary["detected"] / max(summary["injected"], 1),
           "undetected": summary["undetected"],
           "findings_by_severity": summary["findings_by_severity"], "repairs": repairs,
           "post_repair_residual": len(summary["post_repair_residual"]),
           "identical_outside_quarantine": summary["comparison"]["ok"],
           "by_prefix": _by_prefix_verdict(os.path.join(root, "healthy"),
                                           summary["comparison"]),
           "seconds": summary["seconds"], "launches": launches}
    emit("bit-rot", **out)
    if not summary["ok"] or summary["undetected"] or launches["kernel"] < 1:
        raise RuntimeError(f"bit-rot: {out}")
    return out


def phase_crash_sim(torch, dev, workdir: str) -> dict:
    """``crash-sim``: ``run_crash_sim`` of 2 linear days on the card
    (``run-sim --device cuda`` children) at 2 kill points: 1 of the 10
    stage boundaries and 1 store-op point drawn by ``sweep_points`` with
    seed 0 from the artefacts such a run writes. Each child must die at
    its point (``EXIT_KILLED``) and its restart reach the uninterrupted
    twin's artefacts byte for byte; the seconds of each point."""
    from bodywork_tpu_torch.chaos import run_crash_sim, sweep_points
    from bodywork_tpu_torch.chaos.kill import EXIT_KILLED
    from bodywork_tpu_torch.store import schema

    days = [LOOP_START + timedelta(days=i) for i in range(CRASH["days"] + 1)]
    written = ([schema.dataset_key(d) for d in days]
               + [schema.model_key(d) for d in days[:-1]]
               + [schema.model_metrics_key(d) for d in days[:-1]]
               + [schema.test_metrics_key(d) for d in days[1:]])
    store_ops = [p for p in sweep_points(CRASH["days"], 4, written, seed=CRASH["seed"],
                                         store_op_samples=CRASH["store_op_samples"])
                 if p["kind"] == "store_op"]
    points = [{"kind": "stage_boundary", "n": n} for n in CRASH["boundaries"]] + store_ops
    t0 = time.perf_counter()
    summary = run_crash_sim(os.path.join(workdir, "crash"), LOOP_START, CRASH["days"],
                            seed=CRASH["seed"], points=points, model_type="linear",
                            device=dev)
    rows = [{"point": r["point"], "kill_exit": r["kill_exit"],
             "restart_exit": r.get("restart_exit"), "ok": r["ok"],
             "seconds": r.get("seconds"), "error": r.get("error")}
            for r in summary["results"]]
    out = {"days": CRASH["days"], "ok": summary["ok"], "points": rows,
           "seconds": time.perf_counter() - t0}
    emit("crash-sim", **out)
    if not summary["ok"] or any(r["kill_exit"] != EXIT_KILLED for r in rows):
        raise RuntimeError(f"crash-sim: {out} {summary['results']}")
    return out


def _generated_days(torch, dev, days=(date(2026, 7, 1), date(2026, 7, 2), date(2026, 7, 3))):
    """Three days generated on the card, as device tensors (X, y)."""
    import numpy as np

    from bodywork_tpu_torch.data import generate_day

    drawn = [generate_day(d, device=dev) for d in days]
    return (torch.as_tensor(np.concatenate([X for X, _ in drawn]), device=dev),
            torch.as_tensor(np.concatenate([y for _, y in drawn]), device=dev))


def _stacked_models(torch, dev, n: int, widths: tuple, X_hist, y_hist) -> list:
    """``n`` MLPs of ``widths`` with seeded He-init weights (seeds 0..n-1)
    and the generated days' scaler, on the card."""
    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor

    return [MLPRegressor(MLPConfig(hidden=tuple(widths[1:-1])),
                         make_params(torch, dev, X_hist, y_hist, seed=i, widths=widths))
            for i in range(n)]


def _stack_point(torch, dev, models, buckets: tuple, rows: dict) -> dict:
    """One stacked-serving point: the models admitted to a ``scan`` stack
    and a ``vmap`` stack of capacity ``len(models)``; per bucket, each
    tenant's rows through the stacked dispatch against its own solo
    ``torch`` predictor, byte for byte, the ``vmap`` stack's largest
    distance from solo over the outputs' scale, and the device ms of one stacked replay
    against the N sequential solo replays it stands for (CUDA events,
    medians of 30) beside the host ms of one ``predict_multi`` and of N
    solo ``predict`` calls (medians of 10). Then residency churn (an
    eviction, a never-seen tenant's admission, a re-admission) and every
    bucket again: no capture, no build, the re-admitted tenant's bytes its
    solo predictor's."""
    import numpy as np

    from bodywork_tpu_torch.serve.predictor import PaddedPredictor
    from bodywork_tpu_torch.tenancy.stacked import StackedMLPPredictor

    n = len(models)
    tenants = [f"tenant-{i:02d}" for i in range(n)]
    stacks = {mode: StackedMLPPredictor(capacity=n, buckets=buckets, stack_mode=mode,
                                        device=dev) for mode in ("scan", "vmap")}
    for stack in stacks.values():
        for tid, model in zip(tenants, models):
            stack.admit(tid, model)
        stack.warmup()
    solos = [PaddedPredictor(model, buckets=buckets) for model in models]
    for solo in solos:
        solo.warmup()
    rng = np.random.default_rng(15)
    per_bucket = {}
    for bucket in buckets:
        batches = {tid: rng.uniform(0, 100, size=(rows.get(bucket, bucket), 1))
                   .astype(np.float32) for tid in tenants}
        scan = stacks["scan"].predict_multi(batches)
        vmap = stacks["vmap"].predict_multi(batches)
        solo = {tid: s.predict(batches[tid]) for tid, s in zip(tenants, solos)}
        # the distance relative to the outputs' scale, VMAP_RTOL's measure
        vmap_rel = max(float(np.max(np.abs(vmap[t] - solo[t])) / np.max(np.abs(solo[t])))
                       for t in tenants)
        stacked = stacks["scan"]._programs[bucket]
        solo_entry = solos[0]._graph_for(bucket, 1)
        host = {"stacked": [], "sequential": []}
        for _ in range(10):
            t0 = time.perf_counter()
            stacks["scan"].predict_multi(batches)
            host["stacked"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for tid, s in zip(tenants, solos):
                s.predict(batches[tid])
            host["sequential"].append(time.perf_counter() - t0)
        per_bucket[bucket] = {
            "rows_per_tenant": rows.get(bucket, bucket),
            "scan_bytes_equal_solo": {t: scan[t].tobytes() == solo[t].tobytes()
                                      for t in tenants},
            "vmap_max_err_over_scale": vmap_rel,
            "stacked_device_ms": _median_ms(torch, lambda p=stacked: p.graph.replay()),
            "sequential_solo_device_ms": _median_ms(
                torch, lambda e=solo_entry: [e.graph.replay() for _ in range(n)]),
            "stacked_host_ms": 1e3 * statistics.median(host["stacked"]),
            "sequential_solo_host_ms": 1e3 * statistics.median(host["sequential"]),
        }
    stack = stacks["scan"]
    before = stack.stats()
    victim = tenants[-1]
    stack.evict(victim)
    stack.admit("tenant-new", models[0])  # a tenant id the stack never saw
    stack.evict("tenant-new")
    stack.admit(victim, models[-1])  # re-admitted
    readmitted = True
    for bucket in buckets:
        X = np.linspace(1.0, 99.0, min(bucket, 8), dtype=np.float32)[:, None]
        out = stack.predict_multi({victim: X, tenants[0]: X})
        readmitted &= out[victim].tobytes() == solos[-1].predict(X).tobytes()
    after = stack.stats()
    return {"tenants": n, "hidden": list(models[0].config.hidden), "buckets": list(buckets),
            "per_bucket": per_bucket, "captures_at_warmup": before["captures"],
            "captures_over_churn": after["captures"] - before["captures"],
            "builds_over_churn": after["builds"] - before["builds"],
            "readmitted_bytes_equal_solo": readmitted}


def phase_tenancy(torch, dev, workdir: str) -> dict:
    """``tenancy``: stacked multi-tenant serving on the card. Config 15's
    shape (fleets of 2, 4 and 8 MLPs of hidden (32, 32), 8 rows a tenant,
    bucket 8), then 8 tenants of the served (1024, 1024, 1024) MLP at
    buckets (8, 64, 512): every tenant's ``scan`` bytes equal to its solo
    ``torch`` predictor's at every bucket, ``vmap`` within
    ``VMAP_RTOL``, no capture or build across eviction, a never-seen
    admission and re-admission; stacked against sequential-solo device
    and host ms printed."""
    from bodywork_tpu_torch.tenancy.stacked import VMAP_RTOL

    X_hist, y_hist = _generated_days(torch, dev)
    points = []
    for n in TENANCY["fleet_sizes"]:
        models = _stacked_models(torch, dev, n, TENANCY["small_widths"], X_hist, y_hist)
        points.append(_stack_point(torch, dev, models, TENANCY["small_buckets"],
                                   {TENANCY["small_buckets"][0]: TENANCY["small_rows"]}))
    wide = _stacked_models(torch, dev, TENANCY["wide_tenants"], WIDTHS, X_hist, y_hist)
    points.append(_stack_point(torch, dev, wide, TENANCY["wide_buckets"], {}))
    failures = []
    for point in points:
        emit("tenancy", reduced=["fleet sizes 2/4/8 at hidden (32, 32); 8 tenants at full "
                                 "width (config 15 runs 1024-wide fleets of up to 32)"]
             if point is points[-1] else [], **point)
        for bucket, line in point["per_bucket"].items():
            if not all(line["scan_bytes_equal_solo"].values()):
                failures.append((point["tenants"], bucket, "scan bytes"))
            if not line["vmap_max_err_over_scale"] < VMAP_RTOL:
                failures.append((point["tenants"], bucket, "vmap",
                                 line["vmap_max_err_over_scale"]))
        if point["captures_over_churn"] or point["builds_over_churn"] \
                or point["captures_at_warmup"] != len(point["buckets"]) \
                or not point["readmitted_bytes_equal_solo"]:
            failures.append((point["tenants"], "churn"))
    if failures:
        raise RuntimeError(f"tenancy: {failures}")
    return {"points": points}


def phase_fleet_sim(torch, dev, workdir: str) -> dict:
    """``fleet-sim``: ``run_fleet_sim`` of 4 scenario-zoo tenants for 3
    days on the card, ``tenant-01`` NaN-sabotaged on its final day, once
    with the linear model and once with the 1024-wide MLP (fits cut to 200
    Adam steps, as the chaos soak cuts them): every healthy tenant's fleet
    namespace byte-identical to its solo twin, the sabotaged tenant's gate
    rejecting with production held, ``kernel``'s launches over the MLP
    run (> 0: each tenant's serve stage runs ``auto`` -> ``kernel``)."""
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.tenancy import zoo
    from bodywork_tpu_torch.tenancy.fleet import run_fleet_sim

    launches = {name: 0 for name in VARIANTS}
    failures = []
    for model_type, kwargs in (("linear", None), ("mlp", SOAK_MLP)):
        specs = zoo(FLEET["tenants"], n_samples=FLEET["samples_per_day"])
        reset_launches()
        t0 = time.perf_counter()
        summary = run_fleet_sim(os.path.join(workdir, f"fleet-{model_type}"), LOOP_START,
                                FLEET["days"], specs, sabotage_tenant=FLEET["sabotage"],
                                model_type=model_type, device=dev, model_kwargs=kwargs)
        seconds = time.perf_counter() - t0
        run_launches = dict(LAUNCHES)
        for name, count in run_launches.items():
            launches[name] += count
        out = {"model": model_type, "tenants": summary["tenants"],
               "scenarios": [s.scenario for s in specs], "days": FLEET["days"],
               "samples_per_day": FLEET["samples_per_day"],
               "sabotage_tenant": summary["sabotage_tenant"],
               "gate_rejected": summary["gate_rejected"],
               "production_held": summary["production_held"],
               "twins": {t: {"ok": c["ok"], "matched": c["matched"],
                             "mismatched": len(c["mismatched"])}
                         for t, c in summary["comparisons"].items()},
               "ok": summary["ok"], "seconds": seconds, "launches": run_launches,
               "reduced": _SOAK_REDUCED if model_type == "mlp" else []}
        emit("fleet-sim", **out)
        if not summary["ok"] or summary["gate_rejected"] is not True \
                or summary["production_held"] is not True \
                or len(summary["comparisons"]) != FLEET["tenants"] - 1:
            failures.append(out)
        if model_type == "mlp" and run_launches["kernel"] < 1:
            failures.append(("no kernel launch", out))
    if failures:
        raise RuntimeError(f"fleet-sim: {failures}")
    return {"launches": launches}


def _fresh_score(base_url: str, x: float, attempts: int = 6) -> tuple[int, dict, bytes]:
    """One single row on a fresh connection, retried on a refused or reset
    connection (a listener that was just killed): scoring is idempotent."""
    import http.client

    for attempt in range(attempts):
        conn = _connect(base_url)
        try:
            status, headers, body, _s = _score(conn, x)
            return status, headers, body
        except (ConnectionError, http.client.HTTPException, OSError):
            if attempt == attempts - 1:
                raise
            time.sleep(0.05 * 2 ** attempt)
        finally:
            conn.close()
    raise AssertionError("unreachable")


def _closed_loop(base_url: str, clients: int, per_client: int, xs) -> dict:
    """``clients`` closed-loop clients, each on its own keep-alive
    connection after one untimed request: p50/p99 (nearest rank), the
    requests/s, and every answer ``(status, body)`` by row."""
    import threading

    answers = [[] for _ in range(clients)]
    start = threading.Barrier(clients)

    def client(i):
        conn = _connect(base_url)
        _score(conn, 50.0)
        start.wait()
        for k in range(per_client):
            x = xs[(i * per_client + k) % len(xs)]
            status, _h, body, seconds = _score(conn, x)
            answers[i].append((x, status, body, seconds))
        conn.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    seconds = [a[3] for per in answers for a in per]
    return {"requests": len(seconds), "p50_ms": 1e3 * _nearest_rank(seconds, 50),
            "p99_ms": 1e3 * _nearest_rank(seconds, 99),
            "requests_per_s": len(seconds) / wall,
            "answers": [a[:3] for per in answers for a in per]}


def _pid_requests(metrics_dir: str) -> dict:
    """Scored requests per worker pid, from the snapshots the workers
    flush into the service's shared metrics directory."""
    import glob

    counts = {}
    for path in glob.glob(os.path.join(metrics_dir, "obs-metrics-*.json")):
        try:
            payload = json.load(open(path))
        except (OSError, ValueError):
            continue
        family = payload["snapshot"].get("bodywork_tpu_http_requests_total", {})
        counts[payload["pid"]] = sum(s["value"] for s in family.get("samples", [])
                                     if s["labels"].get("route") == "/score/v1")
    return counts


def _card_used_mib(torch, dev) -> float:
    """The card's memory in use by every process, CUDA contexts included
    (``cudaMemGetInfo``: total less free), in MiB."""
    free, total = torch.cuda.mem_get_info(dev)
    return (total - free) / 2**20


def phase_workers(torch, dev, workdir: str) -> dict:
    """``workers``: ``cli serve --workers 2 --metrics`` on the card (the
    ``aio`` front end, ``auto`` -> ``kernel``, ``--max-pending 8``,
    ``--reload-interval 0.5``), two spawned processes with a CUDA context
    each on one ``SO_REUSEPORT`` port, against a one-process ``cli serve``
    of the same store and knobs. Both workers answer (their flushed
    snapshots count requests by pid) with bodies byte-equal to the
    one-process server's; one worker SIGKILLed mid-traffic with zero
    failed scores (a client that retries a refused connection), then
    respawned by the supervisor; a newer checkpoint reaches both workers
    (byte-equal to a one-process service of it); the aggregated
    ``/metrics`` counts every worker's requests; a burst of 64 rows over
    the service-wide budget of 8 sheds with 429 + ``Retry-After`` across
    both processes, counted exactly in the aggregated shed counter. Printed:
    one worker's whole footprint on the card, its CUDA context included
    (the drop in the card's memory in use between the kill and the
    respawn), beside each worker's allocator high-water marks, 6
    closed-loop clients' requests/s and p50/p99 against the one-process
    server (under the budget of 8, so the drive sheds nothing), the
    respawn's seconds and ``kernel``'s launches: each worker's from its
    exit report (every reporting worker must have launched it), and the
    one-process server's from its ``/healthz``, apart."""
    import glob
    import signal
    import threading

    import numpy as np

    from bodywork_tpu_torch.models import save_model
    from bodywork_tpu_torch.serve import serve_latest_model

    store, second, _hist = _serving_models(torch, dev, workdir)
    root = str(store.root)
    knobs = ["--max-pending", str(WORKERS["max_pending"]), "--device", dev.type]
    xs = [round(float(x), 3) for x in np.random.default_rng(21).uniform(0, 100, 64)]
    # the one-process server: the reference bodies and the throughput baseline
    single = _ServeProcess(root, 0.0, args=knobs)
    try:
        reference = {x: _fresh_score(single.base_url, x)[2] for x in xs}
        single_load = _closed_loop(single.base_url, WORKERS["clients"],
                                   WORKERS["per_client"], xs)
        health = single.health()
        single_launches = {**dict.fromkeys(VARIANTS, 0), health["engine"]: health["launches"]}
    finally:
        single.stop()
    tmp = os.path.join(workdir, "workers-tmp")
    os.makedirs(tmp)
    used_before = _card_used_mib(torch, dev)
    t0 = time.perf_counter()
    svc = _ServeProcess(root, WORKERS["reload_s"],
                        args=["--workers", str(WORKERS["workers"]), "--metrics", *knobs],
                        env={"TMPDIR": tmp})
    out, failures = {}, []
    try:
        match = svc.wait_for_line(r"replica process\(es\) listening on (\S+) "
                                  r"\(SO_REUSEPORT, pids \[([\d, ]+)\]\)", 300)
        out["start_s"] = time.perf_counter() - t0
        base = match.group(1).replace("/score/v1", "")
        pids = [int(p) for p in match.group(2).split(",")]
        (metrics_dir,) = glob.glob(os.path.join(tmp, "bodywork-tpu-obs-*"))
        out["pids"] = pids
        used_workers = _card_used_mib(torch, dev)
        # both workers answer, byte for byte the one-process answers
        answers = {x: _fresh_score(base, x) for x in xs[:32]}
        out["bodies_equal_one_process"] = all(
            a[0] == 200 and a[2] == reference[x] for x, a in answers.items())
        time.sleep(0.6)  # two flush intervals
        by_pid = _pid_requests(metrics_dir)
        out["requests_by_pid"] = {str(p): by_pid.get(p, 0) for p in pids}
        if not out["bodies_equal_one_process"] or min(by_pid.get(p, 0) for p in pids) < 1:
            failures.append("both workers answering the one-process bodies")
        # load: closed-loop clients against the two workers
        workers_load = _closed_loop(base, WORKERS["clients"], WORKERS["per_client"], xs)
        out["load"] = {name: {k: v for k, v in load.items() if k != "answers"}
                       for name, load in (("one_process", single_load),
                                          ("workers", workers_load))}
        if not all(s == 200 and b == reference[x] for x, s, b in workers_load["answers"]):
            failures.append("the closed-loop answers")
        # kill one worker mid-traffic: zero failed scores
        victim = pids[0]
        drill = []
        # the card's memory in use from the kill to the respawn: its low
        # is one worker fewer, so the victim's whole footprint, its CUDA
        # context included, is the drop
        low = [used_workers]
        sampling = threading.Event()

        def sample_memory():
            while not sampling.wait(0.005):
                low[0] = min(low[0], _card_used_mib(torch, dev))

        sampler = threading.Thread(target=sample_memory, daemon=True)
        for i in range(WORKERS["drill_requests"]):
            if i == WORKERS["kill_at"]:
                os.kill(victim, signal.SIGKILL)
                t_kill = time.perf_counter()
                sampler.start()
            x = xs[i % len(xs)]
            status, _h, body = _fresh_score(base, x)
            drill.append(status == 200 and body == reference[x])
        out["kill_drill"] = {"requests": len(drill), "failed": drill.count(False),
                             "victim": victim}
        if not all(drill):
            failures.append("failed scores across the kill")
        try:
            respawn = svc.wait_for_line(r"replica respawned as pid (\d+)", 180)
        finally:
            sampling.set()
            sampler.join()
        out["card_used_mib"] = {"before": used_before, "workers": used_workers,
                                "low_after_kill": low[0],
                                "one_worker": used_workers - low[0],
                                "per_worker_mean": (used_workers - used_before)
                                / WORKERS["workers"]}
        out["respawn"] = {"pid": int(respawn.group(1)),
                          "seconds_after_kill": time.perf_counter() - t_kill}
        pids = [p for p in pids if p != victim] + [int(respawn.group(1))]
        answers = {x: _fresh_score(base, x) for x in xs[:32]}
        time.sleep(0.6)
        by_pid = _pid_requests(metrics_dir)
        out["requests_by_pid_after_respawn"] = {str(p): by_pid.get(p, 0) for p in pids}
        if not all(a[0] == 200 and a[2] == reference[x] for x, a in answers.items()) \
                or by_pid.get(pids[-1], 0) < 1:
            failures.append("the respawned worker answering")
        # the aggregated /metrics: every live worker's requests
        text = urllib.request.urlopen(base + "/metrics", timeout=60).read().decode()
        aggregated = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                         if line.startswith('bodywork_tpu_http_requests_total{route="/score/v1"'))
        live = sum(by_pid.get(p, 0) for p in pids)
        out["metrics"] = {"aggregated_score_requests": aggregated, "live_workers_flushed": live}
        if aggregated < live:
            failures.append("the aggregated /metrics")
        # the shared budget: a burst of 64 over max_pending 8, across both
        shed_series = 'bodywork_tpu_serve_shed_total{reason="admission"}'
        shed_before = _metrics_value(base, shed_series)
        conns = [_connect(base) for _ in range(WORKERS["burst"])]
        for c in conns:
            c.connect()
        results = [None] * len(conns)
        barrier = threading.Barrier(len(conns))

        def one(i):
            barrier.wait()
            results[i] = _score(conns[i], xs[i % len(xs)])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(conns))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for c in conns:
            c.close()
        time.sleep(0.6)
        sheds = [r for r in results if r[0] == 429]
        health = get(base + "/healthz")
        out["shed"] = {"burst": len(results), "ok": sum(r[0] == 200 for r in results),
                       "shed_429": len(sheds),
                       "retry_after_s": sorted({r[1].get("Retry-After") for r in sheds}),
                       "metrics_shed_delta": _metrics_value(base, shed_series) - shed_before,
                       "shared_pending": health["admission"]["shared_pending"]}
        if not sheds or None in out["shed"]["retry_after_s"] \
                or out["shed"]["metrics_shed_delta"] != len(sheds) \
                or health["admission"]["shared_pending"] is None \
                or not all(r[2] == reference[xs[i % len(xs)]]
                           for i, r in enumerate(results) if r[0] == 200):
            failures.append("the shared budget's shed")
        # hot reload: a newer checkpoint reaches every worker
        save_model(store, second, date(2026, 7, 4))
        t_save = time.perf_counter()
        fresh = serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                   engine="auto", device=dev, server_engine="aio",
                                   max_pending=WORKERS["max_pending"])
        try:
            reloaded_reference = {x: _fresh_score(fresh.base_url, x)[2] for x in xs[:16]}
        finally:
            fresh.stop()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            answers = {x: _fresh_score(base, x) for x in xs[:16]}
            if all(a[2] == reloaded_reference[x] for x, a in answers.items()):
                break
            time.sleep(0.25)
        out["reload"] = {"seconds": time.perf_counter() - t_save,
                         "bodies_equal_one_process": all(
                             a[2] == reloaded_reference[x] for x, a in answers.items())}
        if not out["reload"]["bodies_equal_one_process"]:
            failures.append("the hot reload")
    finally:
        stopped = svc.stop()
    exits = [json.loads(line.split("replica exiting: ", 1)[1])
             for line in svc.lines if "replica exiting: " in line]
    # the replicas' own launches, from their exit reports (the killed
    # worker leaves none); the one-process server's are a path of their own
    launches = {name: sum(e["launches"].get(name, 0) for e in exits) for name in VARIANTS}
    out["exit_reports"] = exits
    out["stop"] = stopped
    out["launches"] = launches
    out["one_process_launches"] = single_launches
    if "one_worker" in out.get("card_used_mib", {}):
        # the footprint less the allocator's reserve: the CUDA context,
        # the kernels' modules and the runtime's own buffers
        reserved = max((e.get("max_memory_reserved", 0) for e in exits), default=0) / 2**20
        out["card_used_mib"]["one_worker_outside_allocator"] = \
            out["card_used_mib"]["one_worker"] - reserved
    emit("workers", **out)
    if len(exits) != WORKERS["workers"] or any(e["launches"].get("kernel", 0) < 1
                                               for e in exits):
        failures.append("each worker's exit report and its kernel launches")
    if failures:
        raise RuntimeError(f"workers: {failures} {out}")
    return {"launches": launches, "one_process_launches": single_launches}


#: the split phase (``serve --frontends``): config 14's fixed-rate window
#: (250 requests/s for 3 s, seed 23) and config 17's failover drill (a
#: seeded 120 requests/s drive for 10 s, the active dispatcher SIGKILLed
#: at 3 s, leader TTL 1 s, blackout bound TTL + RECONNECT_MAX_S)
SPLIT = {"frontends": 2, "occupancy_rps": 250.0, "occupancy_s": 3.0, "occupancy_seed": 23,
         "occupancy_windows": 1,
         "failover_rps": 120.0, "failover_s": 10.0, "failover_seed": 61, "kill_at_s": 3.0,
         "leader_ttl_s": 1.0, "drill_timeout_s": 120.0}
#: config 14's byte-identity case set (``bench.py::_byte_identity_check``)
SPLIT_CASES = {"single": ("/score/v1", {"X": [50.0]}),
               "batch": ("/score/v1/batch", {"X": [1.0, 2.0, 3.0]}),
               "malformed": ("/score/v1", {"nope": 1})}


def _case_bodies(base_url: str) -> dict:
    """Config 14's case set on fresh connections, ``(status, body)`` each,
    and the single row again in the binary row framing."""
    from bodywork_tpu_torch.serve.wire import BINARY_CONTENT_TYPE, encode_binary_rows

    out = {}
    for name, (route, payload) in SPLIT_CASES.items():
        conn = _connect(base_url)
        try:
            status, _h, _sent, body, _s = _post_json(conn, route, payload)
        finally:
            conn.close()
        out[name] = (status, body)
    conn = _connect(base_url)
    try:
        conn.request("POST", "/score/v1", body=encode_binary_rows([50.0]),
                     headers={"Content-Type": BINARY_CONTENT_TYPE})
        resp = conn.getresponse()
        out["binary"] = (resp.status, resp.read())
    finally:
        conn.close()
    return out


def _families(base_url: str, names: tuple) -> dict:
    """Each family's samples summed over labels, from the aggregated
    ``/metrics`` of a split fleet."""
    with urllib.request.urlopen(base_url + "/metrics", timeout=60) as resp:
        text = resp.read().decode()
    out = dict.fromkeys(names, 0.0)
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name = line.split("{", 1)[0].split(" ", 1)[0]
            if name in out:
                out[name] += float(line.rsplit(" ", 1)[1])
    return out


def _reports(lines: list, tag: str) -> dict:
    """The ``dispatcher <tag>: {...}`` reports in a fleet's output, by pid."""
    marker = f"dispatcher {tag}: "
    return {r["pid"]: r for r in (json.loads(line.split(marker, 1)[1])
                                  for line in lines if marker in line)}


def _launch_rise(lines: list) -> dict:
    """Each engine's launches from every dispatcher's ready report to its
    exit report, summed over the dispatchers that left both."""
    ready, exits = _reports(lines, "ready"), _reports(lines, "exiting")
    return {name: sum(exits[p]["launches"].get(name, 0) - ready[p]["launches"].get(name, 0)
                      for p in exits if p in ready) for name in VARIANTS}


def _cuda_fds(pid: int) -> int:
    """The process's open NVIDIA device files: a CUDA context holds
    ``/dev/nvidiactl`` and the card's node open; a process that never
    touched CUDA holds none."""
    n = 0
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
        except OSError:
            pass
    return n


def _maps_torch(pid: int) -> bool:
    """Whether the process has torch's libraries mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def _compute_apps() -> dict:
    """``nvidia-smi --query-compute-apps=pid,used_memory``: MiB by pid."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = float(mem.strip().split()[0]) if mem.strip() else None
    return apps


def _split_fleet(root: str, args: list, tmp: str):
    """``cli serve --frontends ...`` on the card: the service and its
    base URL, front-end pids and dispatcher pids from the supervisor's
    start line."""
    svc = _ServeProcess(root, 0.0, args=args, env={"TMPDIR": tmp})
    match = svc.wait_for_line(r"front-end process\(es\) listening on (\S+) \(SO_REUSEPORT, "
                              r"pids \[([\d, ]*)\]\); dispatcher pid\(s\) \[([\d, ]+)\]", 300)
    base = match.group(1).replace("/score/v1", "")
    frontends = [int(p) for p in match.group(2).split(",") if p.strip()]
    dispatchers = [int(p) for p in match.group(3).split(",")]
    return svc, base, frontends, dispatchers


def _occupancy_window(base: str) -> dict:
    """Config 14's fixed-rate window through the fleet: the mean flush
    occupancy and the multi-source flushes, read from the aggregated
    ``/metrics`` before and after (the flusher writes every 0.25 s)."""
    from bodywork_tpu_torch.traffic import TrafficConfig, generate_request_log, run_open_loop

    families = ("bodywork_tpu_serve_batch_occupancy_ratio_sum",
                "bodywork_tpu_serve_batch_occupancy_ratio_count",
                "bodywork_tpu_coalesced_multisource_flush_total",
                "bodywork_tpu_rowqueue_rows_total")
    log = generate_request_log(TrafficConfig(rate_rps=SPLIT["occupancy_rps"],
                                             duration_s=SPLIT["occupancy_s"],
                                             seed=SPLIT["occupancy_seed"]))
    time.sleep(0.6)
    s0 = _families(base, families)
    report = run_open_loop(base, log, timeout_s=15.0, duration_s=SPLIT["occupancy_s"])
    time.sleep(0.6)
    s1 = _families(base, families)
    d = {k: s1[k] - s0[k] for k in families}
    flushes = d["bodywork_tpu_serve_batch_occupancy_ratio_count"]
    return {"offered_rps": report.offered_rps, "goodput_in_window_rps":
            report.goodput_in_window_rps, "ok": report.ok, "requests": report.requests,
            "p99_latency_s": report.latency.get("p99_s"), "flushes": flushes,
            "mean_flush_occupancy": (d["bodywork_tpu_serve_batch_occupancy_ratio_sum"]
                                     / flushes if flushes else None),
            "multisource_flushes": d["bodywork_tpu_coalesced_multisource_flush_total"],
            "rowqueue_rows": d["bodywork_tpu_rowqueue_rows_total"]}


def _occupancy(base: str) -> dict:
    """Config 14's window on a warm fleet: one unmeasured drive of the
    same log first (config 14 measures after its capacity ramp), then
    ``occupancy_windows`` measured windows, their flushes pooled."""
    _occupancy_window(base)
    windows = [_occupancy_window(base) for _ in range(SPLIT["occupancy_windows"])]
    flushes = sum(w["flushes"] for w in windows)
    return {"windows": windows, "flushes": flushes,
            "multisource_flushes": sum(w["multisource_flushes"] for w in windows),
            "mean_flush_occupancy": (sum(w["mean_flush_occupancy"] * w["flushes"]
                                         for w in windows) / flushes if flushes else None)}


def _death_drill(svc, base: str, victim: int) -> dict:
    """SIGKILL the shm fleet's dispatcher under a sequential single-row
    drive: every answer a byte-perfect 200 or the honest 503 +
    ``Retry-After`` (none hung past its 30 s timeout), ``/healthz`` 503
    while down, and the supervisor's respawn healing it."""
    import http.client
    import signal

    status, _h, baseline = _fresh_score(base, 50.0)
    if status != 200:
        raise RuntimeError(f"split: the fleet answered {status} before the kill")
    statuses, hung, health_down = [], 0, False
    t_kill = time.perf_counter()
    os.kill(victim, signal.SIGKILL)
    healed_at = None
    while time.perf_counter() - t_kill < SPLIT["drill_timeout_s"]:
        try:
            status, headers, body = _fresh_score(base, 50.0)
        except (OSError, http.client.HTTPException):
            hung += 1
            continue
        statuses.append(status)
        if status == 503:
            if not headers.get("Retry-After"):
                raise RuntimeError("split: a 503 without Retry-After")
            if not health_down:
                try:
                    urllib.request.urlopen(base + "/healthz", timeout=30)
                except urllib.error.HTTPError as exc:
                    health_down = exc.code == 503
        elif status == 200:
            if body != baseline:
                raise RuntimeError("split: a 200 that is not the baseline's bytes")
            if 503 in statuses:
                healed_at = time.perf_counter()
                break
        else:
            raise RuntimeError(f"split: status {status} during the dispatcher's death")
        time.sleep(0.02)
    respawn = svc.wait_for_line(r"dispatcher respawned as pid (\d+)", 60)
    return {"requests": len(statuses), "ok": statuses.count(200),
            "unavailable_503": statuses.count(503), "hung": hung,
            "healthz_503_while_down": health_down,
            "heal_s_after_kill": None if healed_at is None else healed_at - t_kill,
            "respawned_pid": int(respawn.group(1))}


def _leader_pid(root: str) -> int | None:
    """The pid in the dispatcher lease's ``host:pid:nonce`` owner."""
    from bodywork_tpu_torch.serve.leadership import DispatcherLease
    from bodywork_tpu_torch.store import FilesystemStore

    owner = (DispatcherLease(FilesystemStore(root)).peek() or {}).get("owner") or ""
    parts = owner.rsplit(":", 2)
    return int(parts[1]) if len(parts) == 3 else None


def _failover_drill(svc, base: str, root: str, candidates: list) -> dict:
    """Config 17's drill: the seeded open-loop drive, the ACTIVE
    dispatcher (the lease's owner) SIGKILLed at ``kill_at_s``."""
    import signal
    import threading

    from bodywork_tpu_torch.serve.netqueue import RECONNECT_MAX_S
    from bodywork_tpu_torch.traffic import TrafficConfig, generate_request_log, run_open_loop

    log = generate_request_log(TrafficConfig(rate_rps=SPLIT["failover_rps"],
                                             duration_s=SPLIT["failover_s"],
                                             seed=SPLIT["failover_seed"]))
    active = _leader_pid(root)
    if active not in candidates:
        raise RuntimeError(f"split: the lease names {active}, not a candidate {candidates}")
    standby = next(p for p in candidates if p != active)
    box: dict = {}
    driver = threading.Thread(target=lambda: box.setdefault("report", run_open_loop(
        base, log, timeout_s=15.0, duration_s=SPLIT["failover_s"])), daemon=True)
    driver.start()
    time.sleep(SPLIT["kill_at_s"])
    os.kill(active, signal.SIGKILL)
    t_kill = time.perf_counter()
    takeover_s = None
    while takeover_s is None and time.perf_counter() - t_kill < 30:
        if _leader_pid(root) == standby:
            takeover_s = time.perf_counter() - t_kill
        time.sleep(0.02)
    driver.join(timeout=SPLIT["failover_s"] + 60.0)
    report = box.get("report")
    if report is None:
        raise RuntimeError("split: the failover drive never returned")
    return {"active": active, "standby": standby, "leader_after": _leader_pid(root),
            "lease_takeover_s_after_kill": takeover_s,
            "requests": report.requests, "ok": report.ok,
            "unavailable_503": report.unavailable, "shed": report.shed,
            "timeouts": report.timeouts, "transport_errors": report.transport_errors,
            "server_error": report.server_error, "client_error": report.client_error,
            "max_blackout_s": report.max_blackout_s,
            "blackout_bound_s": SPLIT["leader_ttl_s"] + RECONNECT_MAX_S,
            "p99_latency_s": report.latency.get("p99_s")}


def phase_split(torch, dev, workdir: str) -> dict:
    """``split``: ``cli serve --frontends`` on the card, on the 1024-wide
    MLP checkpoint the serving phases serve: N torch-free front ends and
    ONE dispatcher, the one process with a CUDA context (``auto`` ->
    ``kernel`` in captured graphs). (a) an shm fleet of 2 ``aio`` front
    ends answers config 14's case set (single, batch, malformed) with the
    bytes of an in-process ``cli serve`` of the same store, and the binary
    framing the JSON bytes; (b) ``nvidia-smi --query-compute-apps`` and the
    processes' open NVIDIA device files show the dispatcher's context and
    no front end's (the dispatcher's MiB printed: nvidia-smi's where it
    lists the pid, and the card's memory in use with the fleet up against
    before it); (c) ``kernel``'s
    launches rise in the dispatcher, from its ready report to its exit
    report; (d) config 14's fixed-rate window (250 requests/s, 3 s; one
    warm-up drive, then one measured window) merges rows across the front
    ends (multi-source flushes > 0), and its mean flush occupancy at 1
    and 2 front ends is printed with config 14's verdict (``holds``: 2's
    not below 0.95 of 1's); (e) the dispatcher
    SIGKILLed: 503 + ``Retry-After``, ``/healthz`` 503, none hung, then the
    respawn heals byte for byte; (f) a tcp fleet under ``--dtype bfloat16``
    answers the in-process bf16 bytes, ``kernel-bf16``'s launches rising;
    (g) config 17's drill on a tcp fleet with ``--standby`` and a 1 s
    leader TTL: the blackout within TTL + ``RECONNECT_MAX_S`` (6 s), no
    hung request and no error but 503, the standby's graph captures
    unchanged by its takeover."""
    import numpy as np

    t0 = time.perf_counter()
    store, _second, _hist = _serving_models(torch, dev, workdir)
    root = str(store.root)
    tmp = os.path.join(workdir, "split-tmp")
    os.makedirs(tmp)
    out, failures = {}, []
    launches = dict.fromkeys(VARIANTS, 0)

    # the in-process references: f32 (the coalescer the dispatcher arms by
    # default: 2 ms, 64 rows) and bf16
    window = ["--batch-window-ms", "2", "--batch-max-rows", "64"]
    references = {}
    for name, extra in (("float32", []), ("bfloat16", ["--dtype", "bfloat16"])):
        ref = _ServeProcess(root, 0.0, args=[*window, *extra])
        try:
            references[name] = _case_bodies(ref.base_url)
            health = ref.health()
            out[f"reference_{name}"] = {"engine": health["engine"],
                                        "serving_dtype": health["serving_dtype"]}
        finally:
            ref.stop()
    if out["reference_bfloat16"]["engine"] != "kernel-bf16":
        failures.append("the in-process bf16 reference serving kernel-bf16")

    # N=1: the occupancy baseline
    svc, base, _fes, _ds = _split_fleet(root, ["--frontends", "1"], tmp)
    try:
        out["occupancy_n1"] = _occupancy(base)
    finally:
        out["stop_n1"] = svc.stop()
    rise_n1 = _launch_rise(svc.lines)

    # N=2 over shm: (a) bytes, (b) one context, (d) merging, (e) death
    used_before = _card_used_mib(torch, dev)
    t_boot = time.perf_counter()
    svc, base, fes, ds = _split_fleet(root, ["--frontends", str(SPLIT["frontends"])], tmp)
    try:
        out["boot_s"] = time.perf_counter() - t_boot
        (dispatcher,) = ds
        bodies = _case_bodies(base)
        out["bodies_equal_in_process"] = {
            name: bodies[name] == references["float32"][name] for name in SPLIT_CASES}
        out["binary_equals_json"] = bodies["binary"] == bodies["single"]
        if not all(out["bodies_equal_in_process"].values()) or not out["binary_equals_json"]:
            failures.append("(a) the fleet's bytes")
        apps = _compute_apps()
        ours = {"dispatcher": dispatcher, "supervisor": svc.proc.pid,
                **{f"frontend-{i}": p for i, p in enumerate(fes)}}
        out["one_context"] = {
            "nvidia_smi_mib": {name: apps.get(pid) for name, pid in ours.items()},
            "nvidia_smi_pids_visible": bool(set(apps) & set(ours.values())),
            "nvidia_fds": {name: _cuda_fds(pid) for name, pid in ours.items()},
            "front_ends_map_torch": [_maps_torch(pid) for pid in fes],
            # the card's memory in use (cudaMemGetInfo) with the fleet up
            # against before it: the dispatcher's whole footprint, its
            # context included (the front ends hold none)
            "dispatcher_mib": _card_used_mib(torch, dev) - used_before,
        }
        one = out["one_context"]
        if (one["nvidia_fds"]["dispatcher"] < 1
                or any(n for k, n in one["nvidia_fds"].items() if k != "dispatcher")
                or any(one["front_ends_map_torch"])
                or (one["nvidia_smi_pids_visible"]
                    and [k for k, v in one["nvidia_smi_mib"].items() if v is not None]
                    != ["dispatcher"])):
            failures.append("(b) one CUDA context, the dispatcher's")
        out["occupancy_n2"] = _occupancy(base)
        occ1 = out["occupancy_n1"]["mean_flush_occupancy"]
        occ2 = out["occupancy_n2"]["mean_flush_occupancy"]
        if not out["occupancy_n2"]["multisource_flushes"] > 0:
            failures.append("(d) multi-source flushes")
        # config 14's regression verdict, recorded as config 14 records it
        # (bench.py: "holds", the 0.95 its noise floor): one fleet per N
        # reads within a few percent of the other at the same offered load
        # (tools/split_occupancy.py), where --workers N would divide it by N
        out["occupancy_regression"] = {
            "mean_flush_occupancy_by_n": {"1": occ1, "2": occ2},
            "holds": occ1 is not None and occ2 is not None and occ2 >= 0.95 * occ1}
        out["death"] = _death_drill(svc, base, dispatcher)
        death = out["death"]
        if death["hung"] or not death["unavailable_503"] or death["heal_s_after_kill"] is None \
                or not death["healthz_503_while_down"]:
            failures.append("(e) the dispatcher's death and the heal")
        healed = _case_bodies(base)
        if any(healed[name] != references["float32"][name] for name in SPLIT_CASES):
            failures.append("(e) the healed fleet's bytes")
    finally:
        out["stop_n2"] = svc.stop()
    rise_n2 = _launch_rise(svc.lines)
    out["launch_rise"] = {"n1": rise_n1, "n2_respawned": rise_n2}
    if rise_n1["kernel"] < 1 or rise_n2["kernel"] < 1:
        failures.append("(c) kernel's launches rising in the dispatcher")

    # (f) tcp, bf16
    svc, base, _fes, _ds = _split_fleet(root, ["--frontends", "2", "--transport", "tcp",
                                               "--dtype", "bfloat16"], tmp)
    try:
        bodies = _case_bodies(base)
        out["tcp_bf16_bodies_equal_in_process"] = {
            name: bodies[name] == references["bfloat16"][name] for name in SPLIT_CASES}
    finally:
        out["stop_tcp"] = svc.stop()
    rise_tcp = _launch_rise(svc.lines)
    out["launch_rise"]["tcp_bf16"] = rise_tcp
    if not all(out["tcp_bf16_bodies_equal_in_process"].values()) \
            or rise_tcp["kernel-bf16"] < 1:
        failures.append("(f) the tcp bf16 fleet")

    # (g) config 17's failover drill
    svc, base, _fes, ds = _split_fleet(root, [
        "--frontends", "2", "--transport", "tcp", "--standby",
        "--leader-ttl", str(SPLIT["leader_ttl_s"])], tmp)
    try:
        out["failover"] = _failover_drill(svc, base, root, ds)
    finally:
        out["stop_standby"] = svc.stop()
    ready, exits = _reports(svc.lines, "ready"), _reports(svc.lines, "exiting")
    fo = out["failover"]
    standby = fo["standby"]
    misses = (ready.get(standby, {}).get("graph_cache", {}).get("misses"),
              exits.get(standby, {}).get("graph_cache", {}).get("misses"))
    fo["standby_graph_misses_ready_exit"] = misses
    fo["standby_launch_rise"] = (exits[standby]["launches"]["kernel"]
                                 - ready[standby]["launches"]["kernel"]
                                 if standby in exits and standby in ready else None)
    if (fo["max_blackout_s"] > fo["blackout_bound_s"] or fo["timeouts"]
            or fo["transport_errors"] or fo["server_error"] or fo["client_error"]
            or fo["leader_after"] != standby or None in misses or misses[0] != misses[1]
            or not fo["standby_launch_rise"]):
        failures.append("(g) config 17's failover drill")
    for rise in (rise_n1, rise_n2, rise_tcp, _launch_rise(svc.lines)):
        for name in VARIANTS:
            launches[name] += rise[name]
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    emit("split", **out)
    if failures:
        raise RuntimeError(f"split: {failures} {out}")
    return {"launches": launches}


def _metric_sum(base_url: str, name: str, **labels) -> float:
    """The sum of a family's samples on ``/metrics`` whose labels include
    ``labels`` (in whatever order the exposition writes them)."""
    wanted = [f'{k}="{v}"' for k, v in labels.items()]
    total = 0.0
    with urllib.request.urlopen(base_url + "/metrics", timeout=60) as resp:
        for line in resp.read().decode().splitlines():
            if line.startswith(name + "{") and all(w in line for w in wanted):
                total += float(line.rsplit(" ", 1)[1])
    return total


def _ulp_gap(a, b) -> int:
    """The most float32 ulps between two host arrays."""
    import numpy as np

    a, b = np.ascontiguousarray(a, np.float32), np.ascontiguousarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def _replay_ms(torch, predictor, bucket: int) -> float:
    """Device ms of one replay of ``predictor``'s captured bucket graph."""
    return _median_ms(torch, predictor._graph_for(bucket, 1).graph.replay)


def _mesh_graph_cache(torch, dev, first, second, X, smi: str) -> dict:
    """(c): from a cold graph cache, a 2x1 predictor captures its buckets;
    a same-mesh predictor of a same-architecture checkpoint captures
    nothing, rebinds, and answers its own weights; a 1x2 predictor of the
    first checkpoint captures graphs of its own."""
    import numpy as np

    from bodywork_tpu_torch.parallel import ShardedMLPPredictor, make_mesh
    from bodywork_tpu_torch.parallel.mesh import available_devices
    from bodywork_tpu_torch.serve import GRAPH_CACHE, PaddedPredictor

    devices = available_devices(dev)
    buckets = MESH["buckets"]
    GRAPH_CACHE.reset()
    p21 = ShardedMLPPredictor(first, make_mesh(2, 1, devices[:2]), buckets=buckets)
    p21.warmup()
    cold = GRAPH_CACHE.stats()
    swapped = ShardedMLPPredictor(second, make_mesh(2, 1, devices[:2]), buckets=buckets)
    swapped.warmup()
    after_swap = GRAPH_CACHE.stats()
    shard = buckets[0] // 2
    own = PaddedPredictor(second, (shard,))
    want = np.concatenate([own.predict(X[i * shard:(i + 1) * shard]) for i in range(2)])
    answers_own = bool(np.array_equal(swapped.predict(X[:buckets[0]]), want))
    before_tp = GRAPH_CACHE.stats()
    p12 = ShardedMLPPredictor(first, make_mesh(1, 2, devices[:2]), buckets=buckets)
    p12.warmup()
    after_tp = GRAPH_CACHE.stats()
    separate = all(p21._graph_for(b, 1) is not p12._graph_for(b, 1) for b in buckets)
    out = {"buckets": list(buckets), "builds_cold_2x1": cold["misses"],
           "captures_cold_2x1": cold["captures"],
           "swap_captures": after_swap["captures"] - cold["captures"],
           "swap_builds": after_swap["misses"] - cold["misses"],
           "swap_rebinds": after_swap["rebinds"] - cold["rebinds"],
           "swap_answers_own_weights": answers_own,
           "builds_1x2": after_tp["misses"] - before_tp["misses"],
           "captures_1x2": after_tp["captures"] - before_tp["captures"],
           "separate_programs_2x1_1x2": separate, "smi": smi}
    emit("mesh-graph-cache", **out)
    # on the card every build is a capture
    captured = dev.type != "cuda" or (out["captures_cold_2x1"], out["captures_1x2"]) == (
        len(buckets), len(buckets))
    if (cold["misses"] != len(buckets) or out["swap_captures"] or out["swap_builds"]
            or out["swap_rebinds"] < 1 or not answers_own or not captured
            or out["builds_1x2"] != len(buckets) or not separate):
        raise RuntimeError(f"mesh: the graph cache does not keep meshes apart: {out}")
    return out


def _mesh_serving(torch, dev, model, smi: str) -> dict:
    """(a) data-parallel meshes byte-equal to single-device at the shard's
    own bucket, (b) tensor-parallel ones within 1e-4 of single-device,
    each shard holding its slice of W0; each bucket's replay timed
    against the single-device one's."""
    import numpy as np

    from bodywork_tpu_torch.parallel import ShardedMLPPredictor, make_mesh
    from bodywork_tpu_torch.parallel.mesh import available_devices
    from bodywork_tpu_torch.serve import PaddedPredictor

    devices = available_devices(dev)
    rng = np.random.default_rng(17)
    rows = {b: rng.uniform(0, 100, (b, 1)).astype(np.float32) for b in MESH["buckets"]}
    single = {}
    for b, X in rows.items():
        pred = PaddedPredictor(model, (b,))
        single[b] = {"answers": pred.predict(X), "replay_ms": _replay_ms(torch, pred, b)}
    lines = {}
    for kind, meshes in (("dp", MESH["dp"]), ("tp", MESH["tp"])):
        for data, m in meshes:
            mesh = make_mesh(data, m, devices[:data * m])
            for b, X in rows.items():
                pred = ShardedMLPPredictor(model, mesh, buckets=(b,))
                pred.warmup()
                got = pred.predict(X)
                line = {"kind": kind, "mesh": mesh.label, "bucket": b,
                        "replay_ms": _replay_ms(torch, pred, b),
                        "single_replay_ms": single[b]["replay_ms"],
                        "ulps_vs_single_bucket": _ulp_gap(got, single[b]["answers"]),
                        "max_abs_diff_vs_single": float(np.abs(got - single[b]["answers"]).max()),
                        "smi": smi}
                line["rows_per_s"] = b / line["replay_ms"] * 1e3
                line["single_rows_per_s"] = b / single[b]["replay_ms"] * 1e3
                if kind == "dp":
                    shard = b // data
                    own = PaddedPredictor(model, (shard,))
                    want = np.concatenate([own.predict(X[i * shard:(i + 1) * shard])
                                           for i in range(data)])
                    line["byte_equal_at_shard_bucket"] = bool(np.array_equal(got, want))
                    ok = line["byte_equal_at_shard_bucket"]
                else:
                    w0 = model.net.layers[0].w
                    slices = [row["net"]["layers"][0]["w"] for row in pred.shard_params]
                    line["w0_shards"] = [list(t.shape) for t in slices[0]]
                    line["w0_sliced"] = all(
                        torch.equal(torch.cat(s, dim=1), w0)
                        and len({t.data_ptr() for t in s} | {w0.data_ptr()}) == m + 1
                        and all(t.shape[1] == w0.shape[1] // m for t in s) for s in slices)
                    line["within_bar"] = bool(np.allclose(got, single[b]["answers"],
                                                          rtol=MESH["tp_bar"],
                                                          atol=MESH["tp_bar"]))
                    ok = line["w0_sliced"] and line["within_bar"]
                emit(f"mesh-{kind}", **line)
                lines[f"{kind}-{mesh.label}-{b}"] = line
                if not ok:
                    raise RuntimeError(f"mesh: {kind} serving at {mesh.label} fails: {line}")
    return lines


def _mesh_cli_serve(torch, dev, store, model, smi: str) -> dict:
    """(d): ``cli serve --mesh-data 2 --mesh-model 2`` on the card (four
    virtual shards) answers the in-process 2x2 predictor's values, reports
    its mesh and counts its sharded dispatches; under ``--dtype
    bfloat16`` it serves f32 over the mesh and counts
    ``unsupported_mesh``."""
    import numpy as np

    from bodywork_tpu_torch.parallel import ShardedMLPPredictor, make_mesh
    from bodywork_tpu_torch.parallel.mesh import VIRTUAL_DEVICES_ENV, available_devices

    in_process = ShardedMLPPredictor(model, make_mesh(2, 2, available_devices(dev)[:4]))
    env = {VIRTUAL_DEVICES_ENV: str(MESH["virtual"])}
    mesh_args = ["--mesh-data", "2", "--mesh-model", "2"]
    xs = [0.5, 42.0, 99.9]
    batch = np.linspace(0.0, 100.0, 300, dtype=np.float32)
    svc = _ServeProcess(str(store.root), args=mesh_args, env=env)
    try:
        health = svc.health()
        singles = [post(svc.base_url + "/score/v1", {"X": x})["prediction"] for x in xs]
        batched = post(svc.base_url + "/score/v1/batch",
                       {"X": [float(v) for v in batch]})["predictions"]
        dispatches = _metric_sum(svc.base_url, "bodywork_tpu_serve_sharded_dispatch_total",
                                 mesh="2x2")
    finally:
        stopped = svc.stop()
    want_singles = [float(in_process.predict(np.array([[x]], np.float32))[0]) for x in xs]
    want_batch = [float(v) for v in in_process.predict(batch[:, None])]
    bf16 = _ServeProcess(str(store.root), args=[*mesh_args, "--dtype", "bfloat16"], env=env)
    try:
        bf16_health = bf16.health()
        bf16_answer = post(bf16.base_url + "/score/v1", {"X": xs[1]})["prediction"]
        unsupported = _metric_sum(bf16.base_url, "bodywork_tpu_serve_quantization_gate_total",
                                  dtype="bfloat16", outcome="unsupported_mesh")
    finally:
        bf16.stop()
    out = {"mesh": health["mesh"], "engine": health["engine"], "launches": health["launches"],
           "singles_equal": singles == want_singles, "batch_equal": batched == want_batch,
           "sharded_dispatches": dispatches, "sigterm": stopped,
           "bf16_serving_dtype": bf16_health["serving_dtype"], "bf16_mesh": bf16_health["mesh"],
           "bf16_answer_equal_f32": bf16_answer == want_singles[1],
           "unsupported_mesh": unsupported, "smi": smi}
    emit("mesh-cli-serve", **out)
    if (out["mesh"] != {"data": 2, "model": 2} or not out["singles_equal"]
            or not out["batch_equal"] or dispatches < 1
            or out["bf16_serving_dtype"] != "float32" or out["bf16_mesh"] != out["mesh"]
            or not out["bf16_answer_equal_f32"] or unsupported != 1):
        raise RuntimeError(f"mesh: cli serve over a 2x2 mesh fails: {out}")
    return out


def _mesh_fit(torch, dev, store, smi: str) -> tuple[dict, object]:
    """(e): the sharded fit at ``MESH_MLP``'s settings on 2x2 virtual shards:
    its index stream bit-equal to the CPU's; its first step's loss and
    gradients within 1e-5 of the single-device ones on the same draws;
    the fit's seconds beside a single-device fit's; then the fitted
    checkpoint served single-device through ``kernel`` and held to the
    plain version. Returns the line and the fitted model."""
    import numpy as np

    from bodywork_tpu_torch.data import load_all_datasets, prng
    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor
    from bodywork_tpu_torch.models.checkpoint import load_model_bytes, save_model_bytes
    from bodywork_tpu_torch.models.mlp import _loss, draw_indices, init_mlp_params, mlp_apply
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.parallel import make_mesh, train_mlp_sharded
    from bodywork_tpu_torch.parallel.mesh import available_devices
    from bodywork_tpu_torch.parallel.train_step import _standardised, sharded_loss_and_grads
    from bodywork_tpu_torch.serve import build_predictor

    ds = load_all_datasets(store)
    X, y = ds.X.astype(np.float32), ds.y.astype(np.float32)
    cfg = MLPConfig(**MESH_MLP)
    data, m = MESH["fit"]
    mesh = make_mesh(data, m, available_devices(dev)[:data * m])
    k_init, k_batch = prng.split(prng.PRNGKey(cfg.seed))
    n = X.shape[0]
    idx = draw_indices(k_batch, cfg.n_steps, cfg.batch_size, n, device=dev)
    idx_cpu = draw_indices(k_batch, cfg.n_steps, cfg.batch_size, n, device="cpu")
    Xs, ys, _ = _standardised(X.reshape(n, -1), y, dev)
    net = init_mlp_params(k_init, (1, *cfg.hidden, 1), device=dev)
    loss_s, grads_s = sharded_loss_and_grads(net, Xs, ys, idx[0], mesh, cfg)
    leaves = [t.clone().requires_grad_(True) for layer in net["layers"]
              for t in (layer["w"], layer["b"])]
    shaped = {"layers": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                         for i in range(len(net["layers"]))]}
    i0 = idx[0]
    loss_1 = _loss(shaped, Xs[i0], ys[i0], torch.ones(cfg.batch_size, device=dev))
    grads_1 = torch.autograd.grad(loss_1, leaves)
    loss_1 = float(loss_1.detach())
    loss_gap = abs(float(loss_s) - loss_1) / abs(loss_1)
    grad_gap = max(float((a - b).norm() / b.norm()) for a, b in zip(grads_s, grads_1))
    timings = {}
    t0 = time.perf_counter()
    fitted = train_mlp_sharded(X, y, cfg, mesh, timings=timings)
    sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solo = MLPRegressor(cfg).fit(X, y, device=dev)
    single_s = time.perf_counter() - t0
    served = load_model_bytes(save_model_bytes(fitted), device=dev)
    reset_launches()
    predictor = build_predictor(served, "kernel")
    predictor.warmup()
    Xq = np.random.default_rng(23).uniform(0, 100, (300, 1)).astype(np.float32)
    got = predictor.predict(Xq)
    with torch.no_grad():
        plain = mlp_apply(served.params, torch.as_tensor(Xq, device=dev)).cpu().numpy()
    launches = dict(LAUNCHES)
    err = float(np.abs(got - plain).max() / max(1.0, float(np.abs(plain).max())))
    out = {"mesh": mesh.label, "rows": n, "steps": cfg.n_steps, "batch_size": cfg.batch_size,
           "widths": [1, *cfg.hidden, 1], "indices_bit_equal_cpu": bool(
               torch.equal(idx.cpu(), idx_cpu)),
           "step0_loss_gap": loss_gap, "step0_grad_gap": grad_gap, "bar": MESH["step0_bar"],
           "final_loss": fitted.final_loss, "single_final_loss": solo.final_loss,
           "staging_s": timings["staging_s"], "scan_s": timings["scan_s"],
           "sharded_fit_s": sharded_s, "single_fit_s": single_s,
           "served_engine": predictor.engine, "served_err": err, "served_bar": BARS["kernel"],
           "served_launches": launches, "smi": smi}
    emit("mesh-fit", **out)
    if (not out["indices_bit_equal_cpu"] or loss_gap >= MESH["step0_bar"]
            or grad_gap >= MESH["step0_bar"] or not math.isfinite(fitted.final_loss)
            or err > BARS["kernel"] or launches["kernel"] < 1):
        raise RuntimeError(f"mesh: the sharded fit fails: {out}")
    return out, fitted


def _mesh_group(torch, dev, store, smi: str) -> dict:
    """(g): a 1-rank NCCL group through ``multihost_init`` on a local
    coordinator: an all-reduce and a broadcast on the card, the sharded
    fit inside the group byte-equal to the one without, then
    ``multihost_shutdown``."""
    import torch.distributed as dist

    from bodywork_tpu_torch.data import load_all_datasets
    from bodywork_tpu_torch.models import MLPConfig
    from bodywork_tpu_torch.parallel import (
        make_mesh,
        multihost_init,
        multihost_shutdown,
        train_mlp_sharded,
    )
    from bodywork_tpu_torch.parallel.collectives import broadcast_, sum_over_processes
    from bodywork_tpu_torch.parallel.mesh import available_devices

    ds = load_all_datasets(store)
    cfg = MLPConfig(**{**LOOP_MLP, "n_steps": MESH["group_steps"]})
    devices = available_devices(dev)
    alone = train_mlp_sharded(ds.X, ds.y, cfg, make_mesh(2, 2, devices[:4]))
    names = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update({"COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
                       "NUM_PROCESSES": "1", "PROCESS_ID": "0"})
    left = None
    try:
        joined = multihost_init(dev)
        again = multihost_init(dev)
        backend = dist.get_backend()
        t = torch.arange(4, dtype=torch.float32, device=dev)
        broadcast_([t], dist.group.WORLD)
        summed = sum_over_processes(t, dist.group.WORLD)
        dist.all_reduce(t)
        collectives_ok = bool(torch.equal(summed, t) and torch.equal(
            t, torch.arange(4, dtype=torch.float32, device=dev)))
        grouped = train_mlp_sharded(ds.X, ds.y, cfg, make_mesh(2, 2, devices[:4]))
    finally:
        left = multihost_shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    same = all(torch.equal(a.w, b.w) and torch.equal(a.b, b.b)
               for a, b in zip(alone.net.layers, grouped.net.layers))
    out = {"joined": joined, "second_call": again, "backend": backend,
           "collectives_ok": collectives_ok, "steps": cfg.n_steps,
           "fit_bytes_equal_no_group": same, "shutdown": left,
           "shutdown_again": multihost_shutdown(), "smi": smi,
           "unverified": "a group of several processes on several cards (NCCL refuses two "
                         "ranks on one card)"}
    emit("mesh-group", **out)
    if not (joined and again and backend == "nccl" and collectives_ok and same and left) \
            or out["shutdown_again"]:
        raise RuntimeError(f"mesh: the 1-rank NCCL group fails: {out}")
    return out


def _mesh_day(torch, dev, workdir: str, smi: str) -> dict:
    """(f): one MLP day of the default pipeline whose train stage fits
    over a 2x2 mesh (the spec's ``mesh_data`` / ``mesh_model``), gated
    and served from ``production`` (through ``kernel`` on ``auto``), the
    launches counted over the day."""
    import bodywork_tpu_torch.parallel as parallel
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
    from bodywork_tpu_torch.serve import GRAPH_CACHE
    from bodywork_tpu_torch.store import FilesystemStore

    spec = default_pipeline("mlp", "batch")
    spec.stages[TRAIN_STAGE].args.update({**MESH_MLP, "mesh_data": 2, "mesh_model": 2})
    runner = LocalRunner(spec, FilesystemStore(os.path.join(workdir, "mesh-day")), device=dev)
    real, fits = parallel.train_mlp_sharded, []

    def spy(X, y, cfg, mesh, *args, **kwargs):
        fits.append(mesh.label)
        return real(X, y, cfg, mesh, *args, **kwargs)

    GRAPH_CACHE.reset()
    reset_launches()
    parallel.train_mlp_sharded = spy
    try:
        (result,) = runner.run_simulation(LOOP_START, 1)
    finally:
        parallel.train_mlp_sharded = real
    launches = dict(LAUNCHES)
    line = {**_day_line("mlp", result, launches["kernel"]), "fit_meshes": fits, "smi": smi}
    emit("mesh-day", **line)
    if fits != ["2x2"] or (dev.type == "cuda" and line["engine"] != "kernel"):
        raise RuntimeError(f"mesh: the day did not fit over 2x2 and serve on kernel: {line}")
    return {**line, "launches": launches}


def phase_mesh(torch, dev, workdir: str, smi: str) -> dict:
    """``mesh``: the device mesh on virtual shards of ``cuda:0`` (see the
    module docstring, (a)-(g)). The kernels' launches are set to 0 before
    the mesh's own dispatches ((a)-(d), which must launch none) and
    counted over (e)'s and (f)'s serving."""
    import numpy as np

    from bodywork_tpu_torch.models.checkpoint import load_model, resolve_serving_key
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.parallel.mesh import VIRTUAL_DEVICES_ENV

    saved = os.environ.get(VIRTUAL_DEVICES_ENV)
    os.environ[VIRTUAL_DEVICES_ENV] = str(MESH["virtual"])
    t_phase = time.perf_counter()
    try:
        store, second, _hist = _serving_models(torch, dev, workdir)
        first, _ = load_model(store, resolve_serving_key(store)[0], device=dev)
        rows = np.random.default_rng(3).uniform(
            0, 100, (MESH["buckets"][0], 1)).astype(np.float32)
        reset_launches()
        graph = _mesh_graph_cache(torch, dev, first, second, rows, smi)
        serving = _mesh_serving(torch, dev, first, smi)
        cli = _mesh_cli_serve(torch, dev, store, first, smi)
        dispatch_launches = dict(LAUNCHES)
        if any(dispatch_launches.values()):
            raise RuntimeError(f"mesh: the mesh's dispatches launched a kernel: "
                               f"{dispatch_launches}")
        fit, _fitted = _mesh_fit(torch, dev, store, smi)
        day = _mesh_day(torch, dev, workdir, smi)
        group = _mesh_group(torch, dev, store, smi)
    finally:
        if saved is None:
            os.environ.pop(VIRTUAL_DEVICES_ENV, None)
        else:
            os.environ[VIRTUAL_DEVICES_ENV] = saved
    launches = {k: fit["served_launches"][k] + day["launches"][k] for k in VARIANTS}
    out = {"seconds": time.perf_counter() - t_phase, "virtual_shards": MESH["virtual"],
           "dispatch_launches": dispatch_launches, "launches": launches, "smi": smi}
    emit("mesh", **out)
    return {**out, "graph_cache": graph, "serving": serving, "cli": cli, "fit": fit,
            "group": group}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _pods_spec(port: int):
    """The deployed spec: ``default_pipeline("mlp")`` whose train stage
    carries the day loop's 1024-wide MLP and its Adam settings, serving on
    ``port``."""
    from bodywork_tpu_torch.pipeline import default_pipeline

    spec = default_pipeline("mlp", "batch", port=port)
    spec.stages["stage-1-train-model"].args.update({**SOAK_MLP, "hidden": list(HIDDEN)})
    return spec


def _deploy(workdir: str, spec) -> dict:
    """``cli deploy --emit-images`` of ``spec`` in a fresh process, with the
    modules it imported (``-X importtime``)."""
    spec_file = os.path.join(workdir, "pipeline.yaml")
    with open(spec_file, "w") as f:
        f.write(spec.to_yaml())
    out, images = os.path.join(workdir, "k8s"), os.path.join(workdir, "images")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "bodywork_tpu_torch.cli", "deploy",
         "--out", out, "--emit-images", images, "--spec", spec_file],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True, text=True,
        timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"deploy exited {proc.returncode}: {proc.stderr[-3000:]}")
    modules = {line.rsplit("|", 1)[-1].strip().split(".")[0]
               for line in proc.stderr.splitlines() if line.startswith("import time:")}
    return {"out": out, "images": images, "spec_file": spec_file, "seconds": seconds,
            "modules": modules}


def phase_deploy(torch, dev, workdir: str) -> dict:
    """``deploy``: ``python -m bodywork_tpu_torch.cli deploy --out DIR
    --emit-images DIR2`` of the 1024-wide MLP pipeline in a fresh process
    that imports no pyyaml, jsonschema or torch (its own import log says
    so): both validator layers pass every manifest, every written file
    loads back (the port's YAML reader) to the generated document, the
    ConfigMap holds ``to_yaml(spec)`` and ``from_yaml(to_yaml(spec)) ==
    spec``; the documents by kind, each pod's ``nvidia.com/gpu`` and
    nodeSelector, and the derived image tags."""
    import importlib.util

    from bodywork_tpu_torch.pipeline import PipelineSpec, _yaml, generate_manifests
    from bodywork_tpu_torch.pipeline.images import stage_image_tag
    from bodywork_tpu_torch.pipeline.k8s_schema import validate_against_k8s_schema
    from bodywork_tpu_torch.pipeline.k8s_validate import validate_manifest

    spec = _pods_spec(5000)
    run = _deploy(workdir, spec)
    banned = sorted(run["modules"] & {"yaml", "jsonschema", "torch", "matplotlib", "pandas"})
    docs = generate_manifests(spec)
    written = sorted(os.listdir(run["out"]))
    errors, mismatched = [], []
    for name in written:
        with open(os.path.join(run["out"], name)) as f:
            loaded = _yaml.load(f.read())
        if loaded != docs.get(name):
            mismatched.append(name)
        errors += validate_manifest(loaded, name) + validate_against_k8s_schema(loaded, name)
    kinds: dict = {}
    for doc in docs.values():
        kinds[doc["kind"]] = kinds.get(doc["kind"], 0) + 1
    pods = {}
    for name, doc in docs.items():
        spec_of = doc["spec"]["jobTemplate"]["spec"] if doc["kind"] == "CronJob" else doc.get("spec")
        pod = (spec_of or {}).get("template", {}).get("spec")
        if pod:
            pods[name] = {"gpu": pod["containers"][0]["resources"].get("limits", {}).get(
                "nvidia.com/gpu", 0), "node_selector": pod.get("nodeSelector")}
    tags = {name: stage_image_tag(stage, "bodywork-tpu/runtime:latest")
            for name, stage in spec.stages.items()}
    bases = {}
    for name in spec.stages:
        with open(os.path.join(run["images"], name, "Dockerfile")) as f:
            bases[name] = next(line[5:] for line in f.read().splitlines()
                               if line.startswith("FROM "))
    configmap = docs["00-pipeline-spec-configmap.yaml"]["data"]["pipeline.yaml"]
    out = {"files": len(written), "kinds": kinds, "pods": pods, "image_tags": tags,
           "image_bases": bases, "seconds": run["seconds"],
           "banned_modules_imported": banned,
           "pyyaml_installed_here": importlib.util.find_spec("yaml") is not None,
           "validator_errors": errors, "files_not_loading_back": mismatched,
           "spec_round_trips": PipelineSpec.from_yaml(spec.to_yaml()) == spec,
           "configmap_is_the_spec": configmap == spec.to_yaml()}
    emit("deploy", **out)
    if (banned or errors or mismatched or written != sorted(docs) or not out["spec_round_trips"]
            or not out["configmap_is_the_spec"]):
        raise RuntimeError(f"deploy: {out}")
    return out


#: the pods' clocks: POSIX TZ strings with no zoneinfo needed. The pods run
#: on one date and the CronJobs' day loop on the next, as a CronJob fires
#: on a later day: with the UTC hour >= 10 the pods run in UTC and the
#: CronJobs at UTC+14; before, the pods at UTC-12 and the CronJobs in UTC
_TZ_OFFSETS = {"UTC0": 0, "BEHIND12": -12, "AHEAD-14": 14}


def _clock_date(tz: str) -> date:
    from datetime import datetime, timezone

    return (datetime.now(timezone.utc) + timedelta(hours=_TZ_OFFSETS[tz])).date()


def _log_epoch(path: str, pattern: str, tz: str) -> float | None:
    """Wall time of the first log line of ``path`` matching ``pattern``
    (the port's log lines begin with the local time in ``tz``)."""
    import re
    from datetime import datetime, timezone

    with open(path) as f:
        for line in f:
            if re.search(pattern, line):
                stamp = datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")
                zone = timezone(timedelta(hours=_TZ_OFFSETS[tz]))
                return stamp.replace(tzinfo=zone).timestamp()
    return None


def _manifest_commands(out_dir: str, store: str, spec_file: str, stage_dns: str) -> dict:
    """Each written manifest's init and main commands and env, with the
    allowed substitutions: ``python`` -> this interpreter, the store
    mount -> ``store``, the ConfigMap's file -> ``spec_file``, the serve
    Service's DNS name -> 127.0.0.1."""
    from bodywork_tpu_torch.pipeline import _yaml

    def swap(arg: str) -> str:
        if arg == "python":
            return sys.executable
        return (arg.replace("/etc/bodywork/pipeline.yaml", spec_file)
                .replace("/mnt/artefact-store", store).replace(stage_dns, "127.0.0.1"))

    commands = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            doc = _yaml.load(f.read())
        if doc["kind"] not in ("Job", "Deployment", "CronJob"):
            continue
        spec = doc["spec"]["jobTemplate"]["spec"] if doc["kind"] == "CronJob" else doc["spec"]
        pod = spec["template"]["spec"]
        container = pod["containers"][0]
        init = pod.get("initContainers", [])
        commands[name] = {
            "kind": doc["kind"],
            "init": [swap(a) for a in init[0]["command"]] if init else None,
            "command": [swap(a) for a in container["command"]],
            "env": {e["name"]: swap(e["value"]) for e in container.get("env", [])},
            "replicas": spec.get("replicas"),
        }
    return commands


_LIBRARY_LINE = re.compile(r"kernel library (\S+): (built|loaded) (\S+) in ([0-9.]+) s")


def _library_events(log: str) -> list:
    """Each kernel library a process built or loaded (``ops/_build.py``'s
    log line): name, built or loaded, path, seconds."""
    return [{"library": m[0], "action": m[1], "path": m[2], "seconds": float(m[3])}
            for m in _LIBRARY_LINE.findall(log)]


_FRESH_IMAGE_LOAD = """\
import json, sys, time
from pathlib import Path
from bodywork_tpu_torch.ops import _build
_build.DEFAULT_BUILD_DIR = Path(sys.argv[1])
t0 = time.perf_counter()
info = _build.build_all(["mlp_kernel"])["mlp_kernel"]
_build.load_library("mlp_kernel")
print(json.dumps({"built": info["built"], "dir": str(Path(info["path"]).parent),
                  "nvcc_s": info["seconds"], "seconds": time.perf_counter() - t0}))
"""


def _image_without_prebuild(env: dict, cache_dir: str, empty_dir: str) -> dict:
    """Two processes with the serve pod's env, each as from an image
    whose build step left no library (``DEFAULT_BUILD_DIR`` an empty
    directory): the first builds ``mlp_kernel`` into the store's cache,
    the second loads it from there. Each one's build or load seconds."""
    os.makedirs(empty_dir, exist_ok=True)
    out = {}
    for which in ("first", "second"):
        proc = subprocess.run([sys.executable, "-c", _FRESH_IMAGE_LOAD, empty_dir], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"a pod from an image without the prebuild step failed "
                               f"({which}): {proc.stderr[-2000:]}")
        out[which] = json.loads(proc.stdout.strip().splitlines()[-1])
    if os.listdir(empty_dir):
        raise RuntimeError(f"a build went into the empty image's directory: {os.listdir(empty_dir)}")
    return out


def phase_pods(torch, dev, workdir: str, in_process_day_s: float | None = None) -> dict:
    """``pods``: the emitted manifests run as ``kubectl apply -f`` runs
    them, on one store directory, every pod started at once: the train,
    generate and test Jobs and the serve Deployment, each its
    initContainer's ``wait-for`` then its container's command, both read
    from the written YAML, with only the substitutions printed in
    ``reduced``. The store holds one day made by ``cli generate``, as an
    operator seeds it. The gates must order the pods (train after the
    dataset, serve after the model, generate after ``/healthz``, test
    after the new dataset), each exiting 0; the serve pod serves on
    ``kernel`` and its ``/healthz`` launches grow across the test Job; the
    test day's rows POSTed to it agree with the served checkpoint's plain
    version at the ``kernel`` bar; the test Job's process imported no
    torch (its own import log); SIGTERM ends the serve pod as it ends the
    JAX command (no handler). Then each CronJob's command once: the drift
    gate (exit 0 or 4, its table), ``compact``, the ``fsck`` scrub (clean)
    and the day loop for the next date in a fresh process. Each pod's
    seconds: gate wait, process start to the stage body, the body."""
    import signal
    import threading

    from bodywork_tpu_torch.models.checkpoint import load_model
    from bodywork_tpu_torch.ops.mlp_kernel import make_kernel_mlp_apply, mlp_stack_plain
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.store.schema import dataset_key, model_key, test_metrics_key

    pods_tz, cron_tz = ("UTC0", "AHEAD-14") if time.gmtime().tm_hour >= 10 else ("BEHIND12", "UTC0")
    day = _clock_date(pods_tz)
    port = _free_port()
    spec = _pods_spec(port)
    run = _deploy(workdir, spec)
    store_dir = os.path.join(workdir, "store")
    configmap = os.path.join(workdir, "configmap-pipeline.yaml")
    with open(os.path.join(run["out"], "00-pipeline-spec-configmap.yaml")) as f:
        from bodywork_tpu_torch.pipeline import _yaml

        with open(configmap, "w") as g:
            g.write(_yaml.load(f.read())["data"]["pipeline.yaml"])
    commands = _manifest_commands(run["out"], store_dir, configmap,
                                  spec.service_dns("stage-2-serve-model"))
    reduced = {
        "python": sys.executable, "/mnt/artefact-store": "the phase's store directory (commands and env)",
        "/etc/bodywork/pipeline.yaml": "the ConfigMap's data written to a file",
        spec.service_dns("stage-2-serve-model"): f"127.0.0.1 (port {port}, free at generate)",
        "serve replicas": "2 -> 1",
        "clocks": f"pods TZ={pods_tz} (day {day}), CronJobs TZ={cron_tz} (the next day)",
        "test Job env": "PYTHONPROFILEIMPORTTIME=1 (its own import log)",
    }
    seed = _cli(["generate", "--store", store_dir, "--date", str(day)])
    if seed["rc"] != 0:
        raise RuntimeError(f"seeding the store failed: {seed['err'][-2000:]}")
    base = f"http://127.0.0.1:{port}"
    env = {**os.environ, "PYTHONPATH": ROOT, "TZ": pods_tz}
    jobs = {"train": "01-stage-1-train-model-job.yaml", "serve":
            "02-stage-2-serve-model-deployment.yaml",
            "generate": "03-stage-3-generate-next-dataset-job.yaml",
            "test": "04-stage-4-test-model-scoring-service-job.yaml"}
    recs = {name: {} for name in jobs}
    health_across_test = {}

    def pod(name: str) -> None:
        rec, c = recs[name], commands[jobs[name]]
        try:
            pod_env = {**env, **c["env"]}
            if name == "test":
                pod_env["PYTHONPROFILEIMPORTTIME"] = "1"
            rec["started"] = time.time()
            if c["init"]:
                gate = subprocess.run(c["init"], cwd=ROOT, env=pod_env, capture_output=True,
                                      text=True, timeout=600)
                rec["gate_rc"], rec["gate_end"] = gate.returncode, time.time()
                if gate.returncode != 0:
                    rec["error"] = f"gate exited {gate.returncode}: {gate.stderr[-1000:]}"
                    return
            if name == "test":
                health_across_test["before"] = get(base + "/healthz")
            rec["log"] = os.path.join(workdir, f"{name}.log")
            with open(rec["log"], "w") as log:
                rec["proc_start"] = time.time()
                proc = subprocess.Popen(c["command"], cwd=ROOT, env=pod_env,
                                        stdout=subprocess.DEVNULL, stderr=log)
                rec["proc"] = proc
                if name == "serve":
                    return
                rec["rc"] = proc.wait(timeout=900)
                rec["exited"] = time.time()
            if name == "test":
                health_across_test["after"] = get(base + "/healthz")
        except Exception as exc:  # noqa: BLE001 - reported below
            rec["error"] = repr(exc)

    t_pods = time.time()
    threads = [threading.Thread(target=pod, args=(n,)) for n in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    serve = recs["serve"].get("proc")
    try:
        failed = {n: r.get("error") or r.get("rc") for n, r in recs.items()
                  if r.get("error") or (n != "serve" and r.get("rc") != 0)}
        if failed or serve is None or serve.poll() is not None:
            logs = {n: open(r["log"]).read()[-1500:] for n, r in recs.items() if r.get("log")}
            raise RuntimeError(f"pods failed: {failed}; serve alive: "
                               f"{serve is not None and serve.poll() is None}; logs {logs}")
        store = open_store(store_dir)
        expected = [dataset_key(day), model_key(day), dataset_key(day + timedelta(days=1)),
                    test_metrics_key(day + timedelta(days=1))]
        missing = [k for k in expected if not store.exists(k)]
        if missing:
            cause = (" (the clock crossed midnight during the phase)"
                     if _clock_date(pods_tz) != day else "")
            raise RuntimeError(f"the pods' day {day} left no {missing}{cause}")
        mtime = lambda key: os.path.getmtime(os.path.join(store_dir, key))  # noqa: E731
        ready = _log_epoch(recs["serve"]["log"], "listening on", pods_tz)
        order = {
            "train_after_dataset": recs["train"]["gate_end"] >= mtime(dataset_key(day)),
            "serve_after_model": recs["serve"]["gate_end"] >= mtime(model_key(day)),
            "generate_after_healthz": ready is not None and recs["generate"]["gate_end"] >= ready,
            "test_after_new_dataset":
                recs["test"]["gate_end"] >= mtime(dataset_key(day + timedelta(days=1))),
        }
        seconds = {}
        for name, rec in recs.items():
            body = _log_epoch(rec["log"], r"cli\.cmd_run_stage - run-stage ", pods_tz)
            end = ready if name == "serve" else rec["exited"]
            seconds[name] = {"gate_wait_s": rec["gate_end"] - rec["started"],
                             "start_to_body_s": None if body is None else body - rec["proc_start"],
                             "body_s": None if body is None or end is None else end - body}
        day_s = recs["test"]["exited"] - t_pods
        # each pod's kernel libraries, built into or loaded from the
        # store's .kernel-cache (BODYWORK_TPU_COMPILE_CACHE as emitted)
        libraries = {}
        for name, rec in recs.items():
            with open(rec["log"]) as f:
                libraries[name] = _library_events(f.read())
        with open(recs["test"]["log"]) as f:
            test_log = f.read()
        test_torch = sorted({line.rsplit("|", 1)[-1].strip() for line in test_log.splitlines()
                             if line.startswith("import time:")
                             and line.rsplit("|", 1)[-1].strip().split(".")[0] == "torch"})
        imported_any = "import time:" in test_log
        before, after = health_across_test["before"], health_across_test["after"]
        health = get(base + "/healthz")
        # the test day's rows through the serve pod, against the plain
        # version of the checkpoint it serves
        from bodywork_tpu_torch.data import load_latest_dataset

        tested = load_latest_dataset(store)
        got = torch.tensor(post(base + "/score/v1/batch", {"X": tested.X[:, 0].tolist()})[
            "predictions"], device=dev)
        model, _ = load_model(store, health["model_key"], device=dev)
        apply = make_kernel_mlp_apply(model.params, dev)
        want = mlp_stack_plain(apply.layers, torch.as_tensor(tested.X, device=dev), None)
        err, rel = rel_err(got, want)
        launches = health["launches"]
    finally:
        if serve is not None and serve.poll() is None:
            serve.send_signal(signal.SIGTERM)
        serve_rc = serve.wait(timeout=60) if serve is not None else None
    pods_out = {
        "day": str(day), "reduced": reduced, "order": order, "seconds": seconds,
        "day_s": day_s, "in_process_day_s": in_process_day_s,
        "kernel_cache": {"env": commands[jobs["serve"]]["env"].get("BODYWORK_TPU_COMPILE_CACHE"),
                         "libraries": libraries},
        "serve": {"engine": health["engine"], "device": health["device"],
                  "model_key": health["model_key"],
                  "launches_before_test": before["launches"],
                  "launches_after_test": after["launches"], "launches": launches,
                  "sigterm_exit": serve_rc},
        "answers": {"rows": int(tested.X.shape[0]), "rows_of": str(tested.date),
                    "max_abs_err": err, "err_over_scale": rel, "bar": BARS["kernel"]},
        "test_job_imported_torch": test_torch, "test_job_import_log": imported_any,
    }
    emit("pods", **pods_out)
    if (not all(order.values()) or health["engine"] != "kernel"
            or not after["launches"] > before["launches"] or rel >= BARS["kernel"]
            or not bool(torch.isfinite(got).all()) or test_torch or not imported_any
            or serve_rc != -signal.SIGTERM):
        raise RuntimeError(f"pods: {pods_out}")

    # the CronJobs' commands, once each, on the next day's clock
    cron_env = {**os.environ, "PYTHONPATH": ROOT, "TZ": cron_tz}
    cron = {}
    for name in ("99-drift-gate-cronjob.yaml", "99-compact-history-cronjob.yaml",
                 "99-store-scrub-cronjob.yaml", "99-daily-loop-cronjob.yaml"):
        c = commands[name]
        t0 = time.perf_counter()
        proc = subprocess.run(c["command"], cwd=ROOT, env={**cron_env, **c["env"]},
                              capture_output=True, text=True, timeout=900)
        cron[name] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                      "out": proc.stdout, "err": proc.stderr}
    gate, scrub, loop_day = (cron["99-drift-gate-cronjob.yaml"],
                             cron["99-store-scrub-cronjob.yaml"],
                             cron["99-daily-loop-cronjob.yaml"])
    next_day = day + timedelta(days=1)
    fsck = json.loads(scrub["out"]) if scrub["rc"] == 0 else None
    served = _served(loop_day["out"])
    cron_out = {
        "drift_gate": {"exit": gate["rc"], "table": gate["out"].splitlines(),
                       "verdict": [l for l in gate["err"].splitlines() if l.startswith("DRIFT")]},
        "compact": {"exit": cron["99-compact-history-cronjob.yaml"]["rc"],
                    "out": cron["99-compact-history-cronjob.yaml"]["out"].strip()},
        "fsck": {"exit": scrub["rc"], "findings": None if fsck is None else len(fsck["findings"]),
                 "keys_scanned": None if fsck is None else fsck["keys_scanned"]},
        "run_day": {"exit": loop_day["rc"], "day": str(next_day),
                    "day_s": _day_seconds(loop_day["out"], next_day), "served": served},
        "seconds": {name: c["seconds"] for name, c in cron.items()},
        "kernel_cache_libraries": {name: _library_events(c["err"]) for name, c in cron.items()},
    }
    emit("pods-cronjobs", **cron_out)
    # every pod loads a library from the image's prebuilt directory (the
    # checkout's build/torch_kernels, which the build phase filled, as an
    # image's build step does) or from the store's cache; a library is
    # built at most once, and every later pod loads it
    cache_dir = os.path.join(store_dir, ".kernel-cache")
    image_dir = os.path.join(ROOT, "build", "torch_kernels")
    ordered = [e for name in jobs for e in libraries[name]] + [
        e for events in cron_out["kernel_cache_libraries"].values() for e in events]
    cache = {"dir": cache_dir, "image_dir": image_dir, "events": len(ordered),
             "from_image": sum(os.path.dirname(e["path"]) == image_dir for e in ordered),
             "from_cache": sum(os.path.dirname(e["path"]) == cache_dir for e in ordered),
             "outside": [e for e in ordered
                         if os.path.dirname(e["path"]) not in (cache_dir, image_dir)],
             "rebuilt": [e for i, e in enumerate(ordered) if e["action"] == "built"
                         and any(o["library"] == e["library"] for o in ordered[:i])],
             "later_loads": sum(e["action"] == "loaded" for e in ordered[1:]),
             "image_without_prebuild": _image_without_prebuild(
                 {**cron_env, **commands[jobs["serve"]]["env"]}, cache_dir,
                 os.path.join(workdir, "empty-image"))}
    emit("pods-kernel-cache", **cache)
    fresh = cache["image_without_prebuild"]
    if (cache["outside"] or cache["rebuilt"] or not ordered or not cache["later_loads"]
            or not fresh["first"]["built"] or fresh["second"]["built"]
            or {fresh["first"]["dir"], fresh["second"]["dir"]} != {cache_dir}):
        raise RuntimeError(f"pods: the kernel cache was not shared as emitted: {cache}")
    if (gate["rc"] not in (0, 4) or cron["99-compact-history-cronjob.yaml"]["rc"] != 0
            or fsck is None or fsck["findings"] or loop_day["rc"] != 0 or served is None
            or served["engine"] != "kernel" or cron_out["run_day"]["day_s"] is None):
        raise RuntimeError(f"pods CronJobs: {cron_out} {loop_day['err'][-2000:]}")
    return {"launches": {"kernel": launches, "kernel-bf16": 0, "kernel-int8": 0},
            "run_day_launches": served["launches_by_kernel"]}


def phase_profile(torch, dev, workdir: str, label: str = "profile") -> dict:
    """``profile``: ``cli run-sim --profile-dir`` of the 1024-wide MLP for
    PROFILE_SIM's days, its fits cut to PROFILE_SIM's steps, between two
    unprofiled runs of the same command (the first captures the serving
    graphs, so the three serve alike): the trace holds CUDA device events, and the
    f32 kernel appears either by its symbol (then one event per launch
    the wrapper counted over the same window) or only inside graph
    launches (then at least one graph launch per counted launch); the
    trace's bytes and the run's seconds with the profiler on and off.
    The line (``label``) prints the kernels and graph launches by
    correlation id before the checks. The whole script runs it twice:
    as ``profile-after-day-loop`` right after ``day-loop``, whose
    ``day-loop-train-profile`` is the process's first profiler session
    (a later session is the one whose device timestamps drift:
    ``utils/profiling.py``), and as ``profile`` in its place."""
    import contextlib
    import io
    import re

    from bodywork_tpu_torch import cli
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.utils.profiling import trace_path

    prof_dir = os.path.join(workdir, "profile")
    runs = {}
    for name, extra in (("off-first", []), ("on", ["--profile-dir", prof_dir]), ("off", [])):
        argv = ["--log-level", "WARNING", "run-sim", "--store", os.path.join(workdir, name),
                "--days", str(PROFILE_SIM["days"]), "--date", str(LOOP_START),
                "--model", "mlp", "--mlp-hidden", ",".join(map(str, HIDDEN)),
                "--mlp-steps", str(PROFILE_SIM["n_steps"]),
                "--mlp-lr", str(LOOP_MLP["learning_rate"]), "--device", "cuda", *extra]
        reset_launches()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(argv)
        runs[name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                      "day_s": [float(m) for m in re.findall(r"^day \S+: ([0-9.]+)s$",
                                                             printed.getvalue(), re.M)],
                      "launches": dict(LAUNCHES)}
        if rc != 0:
            raise RuntimeError(f"run-sim {name} exited {rc}: {printed.getvalue()[-2000:]}")
    path = str(trace_path(prof_dir, f"{PROFILE_SIM['days']}-day simulation"))
    seen = _kernel_events(path)
    launched = runs["on"]["launches"]["kernel"]
    mode = "named kernel" if seen["f32_kernel_named"] else "graph launch only"
    out = {"days": PROFILE_SIM["days"], "n_steps": PROFILE_SIM["n_steps"],
           "n_steps_cut_from": LOOP_MLP["n_steps"], "trace_bytes": os.path.getsize(path),
           "f32_kernel_appears_as": mode, "launch_counter_kernel": launched, **seen,
           "seconds_profiled": runs["on"]["seconds"], "seconds_unprofiled": runs["off"]["seconds"],
           "runs": runs}
    emit(label, **out)
    if not sum(seen["device_events"].values()) or launched < 1:
        raise RuntimeError(f"the profile holds no device events or no f32 launch: {out}")
    if seen["f32_kernel_named"] and seen["f32_kernel_named"] != launched:
        raise RuntimeError(f"the profile's f32 kernels differ from the launch counter: {out}")
    if not seen["f32_kernel_named"] and seen["graph_launches"] < launched:
        raise RuntimeError(f"the f32 kernel shows neither by name nor in graph launches: {out}")
    return {"launches": {e: sum(r["launches"][e] for r in runs.values()) for e in VARIANTS}}


def _cold_snapshot_train(torch, dev, store, workdir: str) -> dict:
    """After the 30-day incremental linear loop: a fresh ``cli train``
    process must read the history from the snapshot (every covered day
    "from snapshot", at most the tail fetched and parsed); the snapshot
    load is byte-identical to a plain load with ``snapshots/`` deleted;
    both cold loads timed in this process."""
    import hashlib
    import re

    from bodywork_tpu_torch.data.io import load_all_datasets
    from bodywork_tpu_torch.data.snapshot import load_latest_snapshot
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, SNAPSHOTS_PREFIX

    snap = load_latest_snapshot(FilesystemStore(store.root))
    covered = len(snap.entries)
    days = len(store.history(DATASETS_PREFIX))
    train = _cli(["train", "--store", str(store.root), "--model", "linear"])
    m = re.search(r"history parts: (\d+) day\(s\) — (\d+) cached, (\d+) from snapshot, "
                  r"(\d+) fetched\+parsed", train["err"])
    parts = None if m is None else dict(zip(("days", "cached", "from_snapshot", "fetched"),
                                            map(int, m.groups())))
    plain_root = shutil.copytree(store.root, os.path.join(workdir, "no-snapshot"),
                                 ignore=shutil.ignore_patterns("snapshots"))
    t0 = time.perf_counter()
    via_snapshot = load_all_datasets(FilesystemStore(store.root))
    snapshot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = load_all_datasets(FilesystemStore(plain_root))
    plain_s = time.perf_counter() - t0

    def digest(ds):
        return hashlib.sha256(ds.X.tobytes() + ds.y.tobytes()).hexdigest()[:16]

    out = {"days": days, "covered_by_snapshot": covered, "train_rc": train["rc"],
           "train_process_s": train["seconds"], "train_history_parts": parts,
           "rows": len(plain), "cold_load_snapshot_s": snapshot_s, "cold_load_plain_s": plain_s,
           "snapshot_bytes": len(store.get_bytes(snap.key)), "snapshot_key": snap.key,
           "snapshots_kept": len(store.list_keys(SNAPSHOTS_PREFIX)),
           "history_sha256": digest(via_snapshot), "plain_sha256": digest(plain),
           "identical": (via_snapshot.X.tobytes() == plain.X.tobytes()
                         and via_snapshot.y.tobytes() == plain.y.tobytes()
                         and via_snapshot.date == plain.date)}
    emit("snapshot", **out)
    if train["rc"] != 0 or parts is None or parts["from_snapshot"] != covered \
            or parts["fetched"] > days - covered or not out["identical"]:
        raise RuntimeError(f"the cold train did not read the history from the snapshot: "
                           f"{out}\n{train['err'][-3000:]}")
    return out


def _gate_spy():
    """Record what the shadow quantization gate saw and decided (its
    report, verdict and detail) while leaving its decision untouched."""
    from bodywork_tpu_torch.registry import gates

    seen, real = [], gates.evaluate_quantization

    def spy(report, policy=None):
        ok, detail = real(report, policy)
        seen.append({"report": report, "admitted": ok, "detail": detail})
        return ok, detail

    gates.evaluate_quantization = spy
    return seen, lambda: setattr(gates, "evaluate_quantization", real)


def _serve_at_dtype(torch, dev, store, dtype: str, engine: str):
    """The serve stage with ``BODYWORK_TPU_SERVE_DTYPE=dtype`` on the
    store's production: a started handle and the gate's record."""
    from bodywork_tpu_torch.pipeline.stages import StageContext, serve_stage

    seen, restore = _gate_spy()
    before = os.environ.get("BODYWORK_TPU_SERVE_DTYPE")
    os.environ["BODYWORK_TPU_SERVE_DTYPE"] = dtype
    try:
        handle = serve_stage(StageContext(store=store, today=LOOP_START, device=dev),
                             engine=engine)
    finally:
        restore()
        if before is None:
            os.environ.pop("BODYWORK_TPU_SERVE_DTYPE")
        else:
            os.environ["BODYWORK_TPU_SERVE_DTYPE"] = before
    return handle, seen


def phase_quantized(torch, dev, store) -> dict:
    """The serve stage at each quantized dtype on (b)'s production: on
    ``auto`` (the 1024-wide MLP resolves to ``kernel``) the gate must
    admit ``kernel-bf16`` / ``kernel-int8``, whose answers over HTTP are
    held against their plain versions (launches counted from 0 before the
    stage to after its requests); then ``--engine torch`` at each dtype
    (``torch-bf16`` / ``torch-int8``) on the card, held against the same
    predictor on the CPU."""
    from bodywork_tpu_torch.models.checkpoint import load_model
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import build_predictor

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    batches = [torch.rand(n, generator=gen, device=dev) * 100.0 for n in (300, 4096)]
    singles = [50.0, 10.0, 90.0]
    launches, out = {}, {}
    for dtype, engine in (("bfloat16", "kernel-bf16"), ("int8", "kernel-int8")):
        reset_launches()
        handle, gate = _serve_at_dtype(torch, dev, store, dtype, "auto")
        try:
            health, checks = _check_served(torch, dev, handle, singles, batches)
        finally:
            handle.stop()
        launches[engine] = LAUNCHES[engine]
        out[engine] = {"dtype": dtype, "engine": health["engine"],
                       "served_dtype": health["serving_dtype"],
                       "model_key": health["model_key"], "gate": gate,
                       "launches": dict(LAUNCHES), "bar": BARS[engine], **checks}
        emit("quantized", **out[engine])
        if health["engine"] != engine or health["serving_dtype"] != dtype:
            raise RuntimeError(f"dtype={dtype} did not serve through {engine}: {out[engine]}")
        if checks["worst_err_over_scale"] >= BARS[engine] or launches[engine] < 3:
            raise RuntimeError(f"{engine} path failed: {out[engine]}")
    cpu_model, _ = load_model(store, device="cpu")
    X = batches[1]
    for dtype, engine in (("bfloat16", "torch-bf16"), ("int8", "torch-int8")):
        reset_launches()
        handle, gate = _serve_at_dtype(torch, dev, store, dtype, "torch")
        try:
            health = get(handle.base_url + "/healthz")
            got = torch.tensor(post(handle.url + "/batch", {"X": X.tolist()})["predictions"])
        finally:
            handle.stop()
        want = torch.from_numpy(build_predictor(cpu_model, engine).predict(X.cpu().numpy()))
        err, rel = rel_err(got, want)
        out[engine] = {"dtype": dtype, "engine": health["engine"],
                       "served_dtype": health["serving_dtype"], "device": health["device"],
                       "gate": gate, "launches": dict(LAUNCHES), "rows": int(X.shape[0]),
                       "max_abs_err_vs_cpu": err, "err_over_scale_vs_cpu": rel,
                       "bar": CARD_CPU_BARS[engine]}
        emit("quantized-torch", **out[engine])
        if (health["engine"], health["serving_dtype"], health["device"]) != (engine, dtype, "cuda"):
            raise RuntimeError(f"--engine torch at {dtype} did not serve {engine}: {out[engine]}")
        if rel >= CARD_CPU_BARS[engine] or any(LAUNCHES.values()):
            raise RuntimeError(f"{engine} on the card disagrees with the CPU: {out[engine]}")
    torch.cuda.synchronize()
    return {"launches": launches, "paths": out}


def _example(name: str, *argv: str) -> tuple:
    """Run ``examples_torch/<name>.py``'s ``main()`` in this process under a
    patched ``argv``, as ``tests/test_examples.py`` runs the JAX scripts,
    so the kernels' launch counts can be read: ``(stdout, main()'s
    return, seconds)``. A script's exit other than 0 fails the phase."""
    import contextlib
    import importlib.util
    import io

    from bodywork_tpu_torch.utils.logging import configure_logger

    path = os.path.join(ROOT, "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved, sys.argv = sys.argv, [path, *argv]
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            result = module.main()
    except SystemExit as exc:
        if exc.code not in (None, 0):
            raise RuntimeError(f"examples: {name} exited {exc.code}: {out.getvalue()}") from exc
        result = None
    finally:
        sys.argv = saved
        # the scripts log at INFO; the smoke's logs stay at WARNING on stderr
        configure_logger("WARNING", stream=sys.stderr)
    return out.getvalue(), result, time.perf_counter() - t0


def _found(pattern: str, out: str, name: str):
    m = re.search(pattern, out)
    if m is None:
        raise RuntimeError(f"examples: {name} printed no {pattern!r}: {out}")
    return m


def phase_examples(torch, dev, workdir: str) -> dict:
    """``examples``: the port's eight examples (``examples_torch/``) on the
    card in the README's order, on one store seeded with the JAX example
    test's two days: 01 trains (MAPE and R^2 within the JAX test's bars),
    02 serves in a process of its own on a free port, 03 generates the
    next day (its rows within the bars), 04 black-box tests it through
    02, 05 reports; 06 runs the A/B pair, 07 the 1024-wide MLP (``auto``
    must serve it on ``kernel``; ``kernel`` and ``kernel-bf16`` within the
    JAX test's bars of the f32 apply and within ``BARS`` of their plain
    versions), 08 the drift gate (the first flagged live day within the
    bars). Launch counts set to 0 just before 01 and read after 08."""
    from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, mlp_stack_plain, reset_launches
    from bodywork_tpu_torch.store import open_store

    store = os.path.join(workdir, "store")
    seeded = open_store(store)
    for i in range(EXAMPLES["seed_days"]):
        d = EXAMPLES["seed_start"] + timedelta(days=i)
        X, y = generate_day(d, device=dev)
        persist_dataset(seeded, Dataset(X, y, d))
    bars, seconds, out = EXAMPLE_BARS, {}, {}
    failures = []
    reset_launches()
    printed, _, seconds["01"] = _example("01_train_model", "--store", store)
    m = _found(r"'MAPE': ([\d.]+).*'r_squared': ([\d.]+)", printed, "01")
    out["01"] = {"MAPE": float(m.group(1)), "r_squared": float(m.group(2))}
    if not (bars["MAPE"][0] < out["01"]["MAPE"] < bars["MAPE"][1]
            and bars["r_squared"][0] < out["01"]["r_squared"] < bars["r_squared"][1]):
        failures.append(f"01 outside the JAX test's regime: {out['01']}")

    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    server = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples_torch", "02_serve_model.py"),
         "--store", store, "--host", "127.0.0.1", "--port", str(port)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        def ready():
            if server.poll() is not None:
                raise RuntimeError(f"examples: 02 exited {server.returncode} before serving: "
                                   f"{server.stderr.read()[-2000:]}")
            try:
                return get(base + "/healthz")
            except OSError:
                return None

        health = _wait_for(ready, timeout_s=180.0, tick_s=0.2)
        if not health:
            raise RuntimeError("examples: 02 did not answer /healthz within 180 s")
        seconds["02_ready"] = time.perf_counter() - t0
        printed, _, seconds["03"] = _example("03_generate_next_dataset", "--store", store)
        m = _found(r"generated (\d+) rows for (\S+) \(alpha = ([\d.]+)\)", printed, "03")
        out["03"] = {"rows": int(m.group(1)), "date": m.group(2), "alpha": float(m.group(3))}
        if not bars["rows"][0] <= out["03"]["rows"] <= bars["rows"][1]:
            failures.append(f"03 rows outside {bars['rows']}: {out['03']}")
        printed, _, seconds["04"] = _example("04_test_model_scoring_service", "--store", store,
                                             "--url", base)
        header, row = printed.strip().splitlines()[-2:]
        out["04"] = dict(zip(header.split(), row.split()))
        if out["04"].get("n_failures") != "0" or out["04"].get("date") != out["03"]["date"]:
            failures.append(f"04 did not score 03's day cleanly: {out['04']}")
        health = get(base + "/healthz")
        out["02"] = {k: health.get(k) for k in ("engine", "device", "model_info", "model_date")}
        if not str(health.get("device", "")).startswith("cuda"):
            failures.append(f"02 does not serve on the card: {out['02']}")
    finally:
        server.terminate()
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
        server.stderr.close()
    seconds["02"] = time.perf_counter() - t0
    out["02"]["exit"] = server.returncode
    if server.returncode not in (0, 143, -15):
        failures.append(f"02 exited {server.returncode} on SIGTERM")
    printed, _, seconds["05"] = _example("05_model_performance_analytics", "--store", store)
    header = printed.strip().splitlines()[0].split()
    # the gap needs a day with both a train and a live record: in the
    # README's order the live test scores the day after the training's
    m = re.search(r"mean live-vs-train MAPE gap over (\d+) day\(s\): ([-+\d.]+)", printed)
    out["05"] = {"columns": header, "gap": None if m is None else float(m.group(2))}
    if not {"MAPE_train", "MAPE_live"} <= set(header):
        failures.append(f"05: {printed}")

    printed, _, seconds["06"] = _example(
        "06_ab_model_comparison", "--root", os.path.join(workdir, "ab"),
        "--days", str(EXAMPLES["ab_days"]))
    out["06"] = {"s_per_day": {k: float(v) for k, v in re.findall(
        r"(\S+): ([\d.]+)s/day steady-state", printed)}}
    if sorted(out["06"]["s_per_day"]) != ["a-linear", "b-mlp"] or "FAILED" in printed:
        failures.append(f"06: {printed}")

    printed, result, seconds["07"] = _example("07_wide_model", "--store",
                                              os.path.join(workdir, "wide"))
    delta = float(_found(r"delta on 8 rows: ([\d.]+) \((.*)\)", printed, "07").group(1))
    rel = {engine: float(_found(rf"{label} max rel delta vs f32: ([\d.]+)", printed,
                                "07").group(1))
           for engine, label in (("torch-bf16", "torch-bf16 "), ("kernel-bf16", "kernel-bf16"))}
    launches_07 = dict(LAUNCHES)
    plain = {}
    for engine in ("kernel", "kernel-bf16"):
        apply, got = result["applies"][engine], result["answers"][engine]
        if not got.is_cuda or apply.launch is None:
            failures.append(f"07: {engine} did not run on the card")
            continue
        plain[engine] = rel_err(got, mlp_stack_plain(apply.layers, result["rows"],
                                                     VARIANTS[engine]))[1]
        if plain[engine] >= BARS[engine]:
            failures.append(f"07: {engine} {plain[engine]:.3g} from its plain version "
                            f"(bar {BARS[engine]})")
    out["07"] = {"engine": result["engine"], "f32_max_abs_delta": delta,
                 "bf16_max_rel_delta": rel, "err_over_scale_vs_plain": plain,
                 "launches_through_07": launches_07}
    if result["engine"] != "kernel":
        failures.append(f"07: auto served on {result['engine']}, not kernel")
    if delta >= bars["f32_delta"] or max(rel.values()) >= bars["bf16_rel"]:
        failures.append(f"07 outside the JAX test's bars: {out['07']}")

    printed, _, seconds["08"] = _example("08_drift_gate", "--store",
                                         os.path.join(workdir, "drift"))
    m = _found(r"DRIFT detected: (\d+)/(\d+) day\(s\) flagged, first (\S+) "
               r"\(live day (\d+)\)", printed, "08")
    out["08"] = {"flagged": int(m.group(1)), "days": int(m.group(2)), "first": m.group(3),
                 "first_live_day": int(m.group(4))}
    if not (bars["live_day"][0] <= out["08"]["first_live_day"] <= bars["live_day"][1]
            and "drifted=False" in printed and "last 7 days: drifted=True" in printed):
        failures.append(f"08: {printed}")
    launches = dict(LAUNCHES)
    for engine in ("kernel", "kernel-bf16"):
        if launches[engine] < 1:
            failures.append(f"{engine} never launched on the examples' path")
    emit("examples", seconds=seconds, results=out, launches=launches,
         reduced=[f"06: {EXAMPLES['ab_days']} days (the script's default 7)"])
    if failures:
        raise RuntimeError("examples: " + "; ".join(failures))
    return {"launches": launches, "seconds": seconds, "results": out}


def _median_ms(torch, fn, reps: int = TIMING_REPS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(torch, fn) -> float:
    """``fn`` captured once into a CUDA graph and timed as graph replays:
    the device time of its kernels without the host's launch gaps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _median_ms(torch, graph.replay)


def phase_timing(torch, dev, card: dict) -> dict:
    from bodywork_tpu_torch.ops.mlp_kernel import (
        CLUSTER_KERNELS,
        make_kernel_mlp_apply,
        mlp_stack_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    X_all = torch.rand(4096, 1, generator=gen, device=dev) * 100.0
    params = make_params(torch, dev, X_all[:, 0], 0.5 * X_all[:, 0] + 1.0)
    out = {}
    for engine, dtype in VARIANTS.items():
        apply = make_kernel_mlp_apply(params, dev, compute_dtype=dtype)
        # the library yardstick: one addmm per layer in the variant's dtype
        # (int8 has no f32-activation int8 product: dequantized f32 weights)
        lib_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        lib_layers = [
            ((layer["w"].float() * layer["scale"][None, :]) if dtype == "int8"
             else layer["w"]).to(lib_dtype).contiguous()
            for layer in apply.layers
        ]
        lib_bias = [layer["b"].to(lib_dtype) for layer in apply.layers]

        def library(X, lib_layers=lib_layers, lib_bias=lib_bias):
            h = X.to(lib_dtype)
            for i, (w, b) in enumerate(zip(lib_layers, lib_bias)):
                h = torch.addmm(b, h, w)
                if i < len(lib_layers) - 1:
                    h = torch.relu(h)
            return h[:, 0]

        out[engine] = {}
        for rows in TIMING_ROWS:
            X = X_all[:rows].contiguous()
            bound_ms, bound_by = bound(rows, engine, card)
            row = {
                "kernel_ms": _median_ms(torch, lambda: apply.launch(X)),
                "kernel_graph_ms": _graph_ms(torch, lambda: apply.launch(X)),
                "plain_ms": _median_ms(torch, lambda: mlp_stack_plain(apply.layers, X, dtype)),
                "library_ms": _median_ms(torch, lambda: library(X)),
                "library_graph_ms": _graph_ms(torch, lambda: library(X)),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            if engine != "kernel-bf16":
                row["bound_products_ms"] = f32_product_ms(rows, card)
            out[engine][rows] = row
            emit("timing", engine=engine, rows=rows, reps=TIMING_REPS,
                 **_launch_shape(apply, [rows]), **row)
    # the cluster kernels' launch plan: (row tile, cluster size) per batch;
    # time every cluster size the card schedules, beside the planner's pick
    for engine in CLUSTER_KERNELS:
        dtype = VARIANTS[engine]
        picked = make_kernel_mlp_apply(params, dev, compute_dtype=dtype)
        sweep = {}
        for cluster in sorted(picked.launch.clusters):
            apply = make_kernel_mlp_apply(params, dev, compute_dtype=dtype, cluster=cluster)
            sweep[cluster] = {
                rows: _median_ms(torch, lambda: apply.launch(X_all[:rows].contiguous()))
                for rows in (256, 512, 4096)
            }
        emit("timing-launch-plan", engine=engine,
             rows_per_tile=CLUSTER_KERNELS[engine].rows,
             clusters_resident=picked.launch.clusters,
             picked={rows: picked.launch.plan(rows).cluster for rows in (256, 512, 4096)},
             kernel_ms=sweep)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--phases",
        default="device,generator,mlp-draws,build,kernels,slice,serving,trace,traffic,reload,"
                "canary,tune,online-tune,tenancy,ab,day-loop,incremental,quantized,resume,"
                "sigterm,day-report,profile,audit,chaos-sim,bit-rot,crash-sim,fleet-sim,"
                "workers,split,mesh,deploy,pods,examples,timing",
        help="comma-separated subset of the phases to run (default: all; quantized "
             "serves incremental's production, so it runs incremental too)",
    )
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()

    import torch

    if not os.path.isdir(os.path.join(ROOT, "bodywork_tpu_torch")):
        print("chip_smoke: bodywork_tpu_torch/ is not beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bodywork_tpu_torch.device import resolve_device
    from bodywork_tpu_torch.utils.logging import configure_logger
    from bodywork_tpu_torch.utils.watchdog import abort_if_backend_hangs, backend_timeout_from_env

    # stdout carries the JSON lines; the port's logs go to stderr
    configure_logger("WARNING", stream=sys.stderr)

    # every process started from here on carries the run's mark
    os.environ[RUN_ENV] = str(os.getpid())
    # the first CUDA calls and nvidia-smi under the watchdog: a card that
    # hangs in them ends the run with exit 3 and one line on stderr
    watchdog_s = backend_timeout_from_env()
    with abort_if_backend_hangs(watchdog_s, what="CUDA device"):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; the port's smoke runs on the card",
                  file=sys.stderr)
            return 2
        dev = resolve_device("cuda")
        card = phase_device(torch, watchdog_s)
    #: each phase's wall-clock seconds, its process check included
    phase_seconds = {}

    def finished(phase: str, t0: float) -> None:
        _check_processes(phase)
        phase_seconds[phase] = time.perf_counter() - t0

    finished("device", t_start)
    if "generator" in phases:
        t0 = time.perf_counter()
        phase_generator(torch, dev)
        finished("generator", t0)
    if "mlp-draws" in phases:
        t0 = time.perf_counter()
        phase_mlp_draws(torch, dev)
        finished("mlp-draws", t0)
    if "build" in phases:
        t0 = time.perf_counter()
        phase_build()
        finished("build", t0)
    errors = {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        errors = phase_kernels(torch, dev)
        finished("kernels", t0)
    launches, loop, incremental, quantized, timing, resume, sigterm = {}, {}, {}, {}, {}, {}, {}
    serving, traced, reported, profiled, profiled_after_loop = {}, {}, {}, {}, {}
    traffic, reloaded, canaried, ab = {}, {}, {}, {}
    tuned, online_tuned = {}, {}
    audited, chaos_sim, bit_rot, podded = {}, {}, {}, {}
    fleeted, workers, split, meshed, examples = {}, {}, {}, {}, {}
    for phase in ("slice", "serving", "trace", "traffic", "reload", "canary", "tune",
                  "online-tune", "tenancy", "ab", "day-loop",
                  "incremental", "resume", "sigterm", "day-report", "profile", "audit",
                  "chaos-sim", "bit-rot", "crash-sim", "fleet-sim", "workers", "split",
                  "mesh", "deploy", "pods", "examples"):
        if phase not in phases and not (phase == "incremental" and "quantized" in phases):
            continue
        t0 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="chip-smoke-", dir=_scratch_dir())
        try:
            if phase == "slice":
                launches = phase_slice(torch, dev, workdir)
            elif phase == "serving":
                serving = phase_serving(torch, dev, workdir)
            elif phase == "trace":
                traced = phase_trace(torch, dev, workdir)
            elif phase == "traffic":
                traffic = phase_traffic(torch, dev, workdir)
            elif phase == "reload":
                reloaded = phase_reload(torch, dev, workdir, traffic.get("capacity_rps"))
            elif phase == "canary":
                canaried = phase_canary(torch, dev, workdir)
            elif phase == "tune":
                tuned = phase_tune(torch, dev, workdir)
            elif phase == "online-tune":
                online_tuned = phase_online_tune(torch, dev, workdir)
            elif phase == "tenancy":
                phase_tenancy(torch, dev, workdir)
            elif phase == "ab":
                ab = phase_ab(torch, dev, workdir)
            elif phase == "day-report":
                reported = phase_day_report(torch, dev, workdir)
            elif phase == "profile":
                profiled = phase_profile(torch, dev, workdir)
            elif phase == "audit":
                audited = phase_audit(torch, dev, workdir)
            elif phase == "chaos-sim":
                chaos_sim = phase_chaos_sim(torch, dev, workdir)
            elif phase == "bit-rot":
                bit_rot = phase_bit_rot(torch, dev, workdir)
            elif phase == "crash-sim":
                phase_crash_sim(torch, dev, workdir)
            elif phase == "fleet-sim":
                fleeted = phase_fleet_sim(torch, dev, workdir)
            elif phase == "workers":
                workers = phase_workers(torch, dev, workdir)
            elif phase == "split":
                split = phase_split(torch, dev, workdir)
            elif phase == "mesh":
                meshed = phase_mesh(torch, dev, workdir, card["smi"])
            elif phase == "deploy":
                phase_deploy(torch, dev, workdir)
            elif phase == "pods":
                podded = phase_pods(torch, dev, workdir, in_process_day_s=(
                    loop["mlp"]["median_days_2_on_s"] if loop else None))
            elif phase == "examples":
                examples = phase_examples(torch, dev, workdir)
            elif phase == "day-loop":
                loop = phase_day_loop(torch, dev, workdir)
                if "profile" in phases:
                    phase_seconds["day-loop-without-profile"] = time.perf_counter() - t0
                    profiled_after_loop = phase_profile(
                        torch, dev, os.path.join(workdir, "profile-after-day-loop"),
                        label="profile-after-day-loop")
            elif phase == "resume":
                resume = phase_resume(torch, dev, workdir)
            elif phase == "sigterm":
                sigterm = phase_sigterm(torch, dev, workdir)
            else:
                incremental = phase_incremental(torch, dev, workdir)
                if "quantized" in phases:
                    quantized = phase_quantized(torch, dev, incremental["store"])
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        finished(phase, t0)
    if "timing" in phases:
        t0 = time.perf_counter()
        timing = phase_timing(torch, dev, card)
        finished("timing", t0)
    emit("phase-seconds", **phase_seconds)
    emit("total", seconds=time.perf_counter() - t_start, phases=sorted(phases))
    if phases >= {"kernels", "slice", "day-loop", "incremental", "quantized", "timing"}:
        kernels = []
        for engine in VARIANTS:
            t = timing[engine][4096]
            by_path = {"slice": launches[engine], "day-loop": loop["mlp"]["launches"][engine],
                       "gate-rejection": loop["rejection"]["launches"][engine],
                       "incremental": incremental["mlp"]["launches"][engine],
                       "incremental-gate-rejection":
                           incremental["rejection"]["launches_all"][engine],
                       "quantized": sum(p["launches"][engine]
                                        for p in quantized["paths"].values()),
                       # the serial loop the pipelined one is held to
                       "pipelined-serial": loop["pipelined"]["serial_launches"][engine],
                       "pipelined-overlap": loop["pipelined"]["overlap_launches"][engine]}
            # the uncrashed twin day, and the restarted days' own processes
            # (each counted from its start, read from its output)
            if resume:
                by_path["resume"] = resume["twin_launches"][engine] + resume["launches"][engine]
            if sigterm:
                by_path["sigterm-restart"] = sigterm["launches"][engine]
            # the serving machinery's paths: every launch a graph replay or
            # a bucket's capture warm-up, read per path in this run
            for path, counts in serving.get("launches_by_path", {}).items():
                by_path[path] = counts.get(engine, 0)
            # the traced services and their overhead runs; the reported
            # day's own process; the profiled simulation and its two twins
            for path, result, key in (("trace", traced, "launches_all"),
                                      ("traffic", traffic, "launches"),
                                      ("reload", reloaded, "launches"),
                                      ("canary", canaried, "launches"),
                                      ("tune", tuned, "launches"),
                                      ("online-tune", online_tuned, "launches"),
                                      ("ab", ab, "launches"),
                                      ("day-report", reported, "launches"),
                                      ("profile", profiled, "launches"),
                                      ("profile-after-day-loop", profiled_after_loop,
                                       "launches"),
                                      ("audit", audited, "launches"),
                                      ("chaos-sim", chaos_sim, "launches"),
                                      ("bit-rot", bit_rot, "launches"),
                                      ("fleet-sim", fleeted, "launches"),
                                      ("workers", workers, "launches"),
                                      ("workers-one-process", workers,
                                       "one_process_launches"),
                                      ("split", split, "launches"),
                                      ("mesh", meshed, "launches"),
                                      ("examples", examples, "launches")):
                if result:
                    by_path[path] = result[key][engine]
            # the serve pod's launches, read from its /healthz, and the
            # next day's run-day CronJob process's, read from its output
            if podded:
                by_path["pods"] = podded["launches"][engine]
                by_path["pods-run-day"] = podded["run_day_launches"].get(engine, 0)
            kernels.append({
                "name": engine, "route": "cuda", "source": SOURCES[engine],
                "replaces": REPLACES[engine], "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": errors[engine], "ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "kernel_graph_ms": t["kernel_graph_ms"],
                "library_graph_ms": t["library_graph_ms"],
            })
        print(card["smi"], flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _scratch_dir() -> str:
    """A scratch directory inside the checkout (``build/`` is ignored by
    git), so the run writes nothing outside the repository."""
    path = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(path, exist_ok=True)
    return path


if __name__ == "__main__":
    sys.exit(main())
