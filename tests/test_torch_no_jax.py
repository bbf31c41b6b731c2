"""The port stands without JAX and without the JAX package: importing every
module of tf_kaldi_speaker_tpu_torch, and chip_smoke.py's module-level
imports, loads neither jax, jaxlib nor flax, nor any module of
tf_kaldi_speaker_tpu, even with JAX_PLATFORMS set (the JAX package's
__init__ imports jax when it is); no source file of the port names the JAX
package in an import; and chip_smoke.py refuses to run (non-zero exit, no
result line) without a CUDA device or without the rest of the repository."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tf_kaldi_speaker_tpu_torch")


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _chip_smoke_module_imports():
    """The names chip_smoke.py imports at module level."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module)
    return names


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in %r:\n"
        "    importlib.import_module(m)\n"
        "import tf_kaldi_speaker_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 23, mods\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tf_kaldi_speaker_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    ) % (_chip_smoke_module_imports(),)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _port_sources():
    return sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)) + [
        os.path.join(ROOT, "chip_smoke.py")]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_the_jax_package(path):
    """No import statement, at any depth, names tf_kaldi_speaker_tpu or a
    module of it."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] == "tf_kaldi_speaker_tpu"]
    assert not bad, bad


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
