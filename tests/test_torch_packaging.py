"""The port's packaging in ``pyproject.toml``: every non-Python file that
``horovod_tpu_torch`` opens at run time ships as package data (the CUDA
sources it builds with ``nvcc``, the native core's ``core.cc`` it builds
with ``g++``, the static checker's ``baseline.txt``), and the port's
launcher has a console script of its own beside the JAX package's
``hvdrun``."""

import fnmatch
import importlib
import os
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "horovod_tpu_torch"
# Build outputs made at run time (git-ignored), never shipped.
BUILD_DIRS = {"__pycache__", "_build", "build"}


def _pyproject() -> dict:
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def _data_files() -> list:
    """Every non-``.py`` file under the port's package, relative to the
    repo root (build outputs excluded)."""
    out = []
    for root, dirs, files in os.walk(os.path.join(REPO, PKG)):
        dirs[:] = sorted(d for d in dirs if d not in BUILD_DIRS)
        for name in sorted(files):
            if not name.endswith((".py", ".pyc")):
                out.append(os.path.relpath(os.path.join(root, name), REPO))
    return out


def _shipped(rel: str, package_data: dict) -> bool:
    """True when a ``package-data`` glob of one of ``rel``'s enclosing
    packages matches it (setuptools resolves the glob against the
    package's directory)."""
    parts = rel.split(os.sep)
    for i in range(1, len(parts)):
        pkg = ".".join(parts[:i])
        rest = "/".join(parts[i:])
        if any(fnmatch.fnmatchcase(rest, g)
               for g in package_data.get(pkg, ())):
            return True
    return False


# The files the port opens at run time, by the module that opens them.
RUNTIME_FILES = (
    f"{PKG}/_core/src/core.cc",          # _core/__init__.py: g++
    f"{PKG}/analysis/baseline.txt",      # analysis/findings.py
    f"{PKG}/ops/csrc/flash_fwd.cu",      # ops/_build.py: nvcc
    f"{PKG}/ops/csrc/flash_bwd.cu",
    f"{PKG}/ops/csrc/flash_decode.cu",
    f"{PKG}/ops/csrc/bn_bwd.cu",
    f"{PKG}/ops/csrc/fused_update.cu",
    f"{PKG}/ops/csrc/common.cuh",
    f"{PKG}/ops/csrc/mma.cuh",
)


@pytest.mark.parametrize("rel", RUNTIME_FILES)
def test_runtime_file_is_package_data(rel):
    assert os.path.isfile(os.path.join(REPO, rel)), rel
    data = _pyproject()["tool"]["setuptools"]["package-data"]
    assert _shipped(rel.replace("/", os.sep), data), \
        f"{rel} matches no package-data glob of its package"


def test_every_non_python_file_of_the_port_ships():
    data = _pyproject()["tool"]["setuptools"]["package-data"]
    files = _data_files()
    assert set(f.replace(os.sep, "/") for f in files) >= set(RUNTIME_FILES)
    missing = [f for f in files if not _shipped(f, data)]
    assert not missing, missing


def test_the_package_finder_takes_the_port():
    include = _pyproject()["tool"]["setuptools"]["packages"]["find"][
        "include"]
    assert any(fnmatch.fnmatchcase(PKG, g) for g in include), include


@pytest.mark.parametrize("script,target", [
    ("hvdrun-torch", "horovod_tpu_torch.run.launch:main"),
    ("hvdrun", "horovod_tpu.run.launch:main"),
])
def test_console_script_resolves_to_a_callable(script, target):
    scripts = _pyproject()["project"]["scripts"]
    assert scripts[script] == target
    if script == "hvdrun-torch":
        module, attr = target.split(":")
        fn = getattr(importlib.import_module(module), attr)
        assert callable(fn)
