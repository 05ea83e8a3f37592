"""The benchmark of ``bodywork_tpu_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line. Everything that belongs to one configuration, one
traffic mix or one per-layer metric is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (which names its
driver under ``drivers/``) and ``metrics/<metric>.py``. The plain
reference that decides ``correct`` is under ``reference/``. Cells that
were measured and left out of ``BENCHMARK.json`` wait in ``parked.json``
with their reasons; a run can still name one.
"""
