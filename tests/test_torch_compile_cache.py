"""The kernel-library cache (``utils/compile_cache.py``, ``ops/_build.py``):
where the libraries go, and that processes building into one directory
never share a temporary file. Nothing is compiled here: this machine has no
``nvcc``, so the paths are read from ``library_path`` and the concurrent
builds run a stand-in compiler."""
import json
import os
import subprocess
import sys
import textwrap
from datetime import date
from pathlib import Path

import pytest

from bodywork_tpu.audit.fsck import run_fsck as jax_run_fsck
from bodywork_tpu.store import open_store as jax_open_store
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.audit.fsck import run_fsck
from bodywork_tpu_torch.ops import _build
from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.store.schema import ALL_PREFIXES
from bodywork_tpu_torch.utils.compile_cache import ENV_VAR, enable_compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def default_build_dir():
    """Each test starts and ends on the default directory, with no cache
    variable set (``enable_compile_cache`` sets it for the process)."""
    saved = os.environ.pop(ENV_VAR, None)
    yield
    os.environ.pop(ENV_VAR, None)
    if saved is not None:
        os.environ[ENV_VAR] = saved


def test_without_a_cache_the_libraries_stay_in_the_default_directory():
    assert enable_compile_cache() is None
    assert _build.build_dir() == _build.DEFAULT_BUILD_DIR
    assert _build.library_path("mlp_kernel").parent == ROOT / "build" / "torch_kernels"


def test_the_env_var_points_the_builds_at_its_directory(tmp_path):
    cache = tmp_path / "env-cache"
    os.environ[ENV_VAR] = str(cache)
    assert enable_compile_cache() == str(cache)
    assert cache.is_dir()
    assert _build.library_path("mlp_kernel").parent == cache


def test_an_explicit_path_beats_the_env_var(tmp_path):
    os.environ[ENV_VAR] = str(tmp_path / "env-cache")
    explicit = tmp_path / "explicit"
    assert enable_compile_cache(str(explicit)) == str(explicit)
    assert os.environ[ENV_VAR] == str(explicit)  # what child processes inherit
    assert {p.name for p in tmp_path.iterdir()} == {"explicit"}
    for name in _build.SOURCES:
        assert _build.library_path(name).parent == explicit


def test_a_child_process_inherits_the_cache(tmp_path):
    """Every process of a pod reads the variable at build time, as every
    JAX process reads XLA's cache variable: a spawned worker or
    dispatcher builds into the cache its parent was given."""
    enable_compile_cache(str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-c", "from bodywork_tpu_torch.ops import _build; "
                               "print(_build.library_path('mlp_int8'))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True,
    ).stdout.strip()
    assert Path(out).parent == tmp_path


def test_enabling_the_cache_imports_no_torch(tmp_path):
    """The test stage's pod gets the variable too, and imports no torch."""
    code = ("import sys\nfrom bodywork_tpu_torch.utils.compile_cache import "
            f"enable_compile_cache\nenable_compile_cache({str(tmp_path)!r})\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert out.splitlines()[-1] == "[]"


def test_the_cli_flag_reaches_the_build_directory(tmp_path):
    cache, store = tmp_path / "flag-cache", tmp_path / "store"
    rc = cli.main(["--compile-cache", str(cache), "registry", "list", "--store", str(store)])
    assert rc in (0, 1)
    assert cache.is_dir()
    assert _build.library_path("mlp_bf16_tc").parent == cache
    # both CLIs take the flag at the top level, before the command
    from bodywork_tpu import cli as jax_cli

    for build_parser in (jax_cli.build_parser, cli.build_parser):
        args = build_parser().parse_args(["--compile-cache", str(cache), "registry", "list",
                                          "--store", str(store)])
        assert args.compile_cache == str(cache)


_FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import sys, time
    if "--version" in sys.argv:
        print("Cuda compilation tools, release {version}")
        sys.exit(0)
    out = sys.argv[sys.argv.index("-o") + 1]
    with open({log!r}, "a") as log:
        log.write(out + "\\n")
    time.sleep(0.5)  # both processes hold their temporary file at once
    with open(out, "w") as f:
        f.write("library")
    print("ptxas info    : Used 1 registers")
""")

_BUILDER = textwrap.dedent("""\
    import os, socket, sys
    os.getpid = lambda: 4242  # two containers, each numbering its own processes
    socket.gethostname = lambda: "pod"
    os.environ["BODYWORK_TPU_COMPILE_CACHE"] = sys.argv[1]
    from bodywork_tpu_torch.ops import _build
    _build._nvcc = lambda: sys.argv[2]
    info = _build.build_all(["mlp_kernel"])["mlp_kernel"]
    print(info["built"], info["path"])
""")


def _write_nvcc(path: Path, log: Path, version: str = "12.4") -> Path:
    path.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log), version=version))
    path.chmod(0o755)
    return path


def test_concurrent_builds_with_one_pid_write_distinct_temporary_files(tmp_path):
    cache, log = tmp_path / "cache", tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    _write_nvcc(nvcc, log)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(cache), str(nvcc)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    tmps = log.read_text().split()
    assert len(tmps) == 2 and len(set(tmps)) == 2, tmps
    assert all(Path(t).parent == cache and "pod-4242-" in Path(t).name for t in tmps)
    library = outs[0][0].split()[-1].rsplit("/", 1)[-1]
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        [library, library.replace(".so", ".log"),
         library.replace(".so", ".sha256")])  # no temporary file left behind
    assert (cache / library).read_text() == "library"
    assert all(out.split()[-1] == str(cache / library) for out, _err in outs)


def _tmp_names(n: int) -> set[str]:
    return {_build._tmp_name("mlp_kernel-0.so") for _ in range(n)}


def test_temporary_names_carry_host_pid_and_a_random_suffix():
    names = _tmp_names(64)
    assert len(names) == 64
    assert all(n.startswith(".tmp-") and f"-{os.getpid()}-" in n for n in names)


def test_the_kernel_cache_is_invisible_to_the_store_and_fsck(tmp_path):
    """The dotted directory the pods share, beside the artefacts of a
    day: no prefix listing shows it, and both packages' fsck stay clean,
    as with the JAX generator's ``.xla-cache``."""
    root = tmp_path / "store"
    LocalRunner(default_pipeline("linear"), open_store(root), device="cpu").run_simulation(
        date(2026, 7, 1), 1)
    for dotted in (".kernel-cache", ".xla-cache"):
        (root / dotted).mkdir()
        (root / dotted / "mlp_kernel-0123456789abcdef.so").write_bytes(b"\x7fELF")
        (root / dotted / "mlp_kernel-0123456789abcdef.log").write_text("ptxas info")
    store = open_store(root)
    for prefix in ALL_PREFIXES:
        assert not [k for k in store.list_keys(prefix) if k.startswith(".")], prefix
    report = run_fsck(store)
    assert report["clean"] and report["ok"], report["findings"]
    jax_report = jax_run_fsck(jax_open_store(str(root)))
    assert jax_report["clean"] and jax_report["ok"], jax_report["findings"]
    assert report["keys_scanned"] == jax_report["keys_scanned"]
    assert json.dumps(report).count("kernel-cache") == 0
    assert cli.main(["fsck", "--store", str(root)]) == 0


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    """``ops/_build`` on a stand-in compiler, with the image's directory
    (``DEFAULT_BUILD_DIR``) under ``tmp_path``: returns the compiler's
    log of outputs, one line a build."""
    log = tmp_path / "nvcc.log"
    nvcc = _write_nvcc(tmp_path / "nvcc", log)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "DEFAULT_BUILD_DIR", tmp_path / "image")
    _build._toolkit.cache_clear()
    yield log
    _build._toolkit.cache_clear()


def _builds(log: Path) -> list[str]:
    return log.read_text().split() if log.exists() else []


def test_the_images_prebuilt_library_is_loaded_before_the_cache(tmp_path, fake_toolkit):
    """An image's build step fills ``build/torch_kernels/``; a pod given
    the store's cache loads from the image and builds nothing there."""
    image = _build.build_all(["mlp_kernel"])["mlp_kernel"]
    assert image["built"] and Path(image["path"]).parent == tmp_path / "image"
    enable_compile_cache(str(tmp_path / "cache"))
    info = _build.build_all(["mlp_kernel"])["mlp_kernel"]
    assert not info["built"] and info["path"] == image["path"]
    assert _build.library_path("mlp_kernel") == Path(image["path"])
    assert list((tmp_path / "cache").iterdir()) == []
    assert len(_builds(fake_toolkit)) == 1


def test_a_library_the_image_lacks_is_built_once_into_the_cache(tmp_path, fake_toolkit):
    enable_compile_cache(str(tmp_path / "cache"))
    first = _build.build_all(["mlp_int8"])["mlp_int8"]
    again = _build.build_all(["mlp_int8"])["mlp_int8"]
    assert first["built"] and not again["built"]
    assert Path(first["path"]).parent == tmp_path / "cache" == Path(again["path"]).parent
    assert not (tmp_path / "image").exists()
    assert len(_builds(fake_toolkit)) == 1


def test_a_damaged_library_is_built_again(tmp_path, fake_toolkit):
    """A library whose bytes no longer match the checksum written beside
    it, in the image or in the cache, is never loaded."""
    image = Path(_build.build_all(["mlp_bf16_tc"])["mlp_bf16_tc"]["path"])
    image.write_text("librarx")
    enable_compile_cache(str(tmp_path / "cache"))
    assert _build.library_path("mlp_bf16_tc").parent == tmp_path / "cache"
    cached = _build.build_all(["mlp_bf16_tc"])["mlp_bf16_tc"]
    assert cached["built"] and Path(cached["path"]).parent == tmp_path / "cache"
    Path(cached["path"]).write_text("librarx")
    assert _build.build_all(["mlp_bf16_tc"])["mlp_bf16_tc"]["built"]
    assert Path(cached["path"]).read_text() == "library"
    assert len(_builds(fake_toolkit)) == 3


def test_another_toolkit_gets_libraries_of_its_own(tmp_path, fake_toolkit, monkeypatch):
    """A cache on the store outlives images: a library one toolkit built
    is never loaded under another."""
    enable_compile_cache(str(tmp_path / "cache"))
    old = _build.library_path("mlp_kernel")
    newer = _write_nvcc(tmp_path / "nvcc-12.8", fake_toolkit, version="12.8")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(newer))
    _build._toolkit.cache_clear()
    new = _build.library_path("mlp_kernel")
    assert new.parent == old.parent and new.name != old.name
    assert new.name.startswith("mlp_kernel-") and new.suffix == ".so"
