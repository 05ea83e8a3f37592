"""The bring-up watchdog (``utils/watchdog.py``) against the JAX module's,
each in a subprocess of its own: a hanging body ends the process with
exit 3 and one line on stderr within the timeout plus 5 s, a body that
finishes (or raises) disarms it, and a malformed timeout in the
environment falls back to the default with a warning."""
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bodywork_tpu.utils import watchdog as jax_watchdog
from bodywork_tpu_torch.utils import watchdog

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": "bodywork_tpu.utils.watchdog", "port": "bodywork_tpu_torch.utils.watchdog"}
TIMEOUT_S = 0.5


def _run(package: str, body: str, env: dict | None = None, timeout: float = 60):
    code = (f"import sys, time\nfrom {PACKAGES[package]} import "
            f"abort_if_backend_hangs, backend_timeout_from_env\n{body}")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout, env=env)
    return proc, time.monotonic() - t0


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_a_hanging_body_exits_3_with_one_line(package):
    proc, seconds = _run(package, f"""\
with abort_if_backend_hangs({TIMEOUT_S}):
    time.sleep(30)
print("not reached")
""")
    assert proc.returncode == 3 == watchdog.BACKEND_UNREACHABLE_EXIT
    assert proc.stdout == ""
    lines = proc.stderr.strip().splitlines()
    assert len(lines) == 1 and f"unreachable after {TIMEOUT_S}s" in lines[0], proc.stderr
    assert seconds < TIMEOUT_S + 5
    if package == "port":
        assert lines[0].startswith("CUDA device unreachable") and "CUDA driver" in lines[0]


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_a_finishing_body_disarms_the_watchdog(package):
    proc, _ = _run(package, f"""\
with abort_if_backend_hangs({TIMEOUT_S}):
    pass
try:
    with abort_if_backend_hangs({TIMEOUT_S}):
        raise KeyError("not a hang")
except KeyError:
    pass
with abort_if_backend_hangs(0):  # disabled
    time.sleep({TIMEOUT_S} * 2)
time.sleep({TIMEOUT_S} * 3)  # an armed timer would fire here
print("alive")
""")
    assert (proc.returncode, proc.stdout.strip(), proc.stderr) == (0, "alive", "")


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_a_malformed_env_value_falls_back_to_the_default(package):
    var = "BODYWORK_TPU_BACKEND_TIMEOUT_S" if package == "port" else "GRAFT_BACKEND_TIMEOUT_S"
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", var: "soon"}
    proc, _ = _run(package, "print(backend_timeout_from_env())", env=env)
    assert proc.returncode == 0 and proc.stdout.strip() == "120.0"
    assert proc.stderr.strip() == f"watchdog: ignoring malformed {var}='soon'; using 120.0s"
    proc, _ = _run(package, "print(backend_timeout_from_env())", env={**env, var: "7.5"})
    assert proc.stdout.strip() == "7.5"


def test_the_port_keeps_the_jax_exit_code_and_default():
    assert watchdog.BACKEND_UNREACHABLE_EXIT == jax_watchdog.BACKEND_UNREACHABLE_EXIT == 3
    assert watchdog.backend_timeout_from_env("NO_SUCH_VARIABLE_SET") == 120.0
    assert not hasattr(watchdog, "force_cpu_platform")
