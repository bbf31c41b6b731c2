"""The port stands without JAX: importing every module of
tf_kaldi_speaker_tpu_torch loads neither jax nor flax, and chip_smoke.py
refuses to run (non-zero exit, no result line) without a CUDA device or
without the rest of the repository."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # the JAX package's __init__ imports jax when set
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tf_kaldi_speaker_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


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
