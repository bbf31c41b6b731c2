"""The port stands without JAX and without the JAX package: importing every
module of tf_kaldi_speaker_tpu_torch, and chip_smoke.py's module-level
imports, loads neither jax, jaxlib nor flax, nor any module of
tf_kaldi_speaker_tpu, even with JAX_PLATFORMS set (the JAX package's
__init__ imports jax when it is); no source file of the port names the JAX
package in an import, no line of the port's recipe scripts calls one of its
modules, and the native reader and WFST decoder build from the port's own
sources; and chip_smoke.py refuses to run (non-zero exit, no
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
        "assert len(mods) >= 110, mods\n"
        "assert {'tf_kaldi_speaker_tpu_torch.kio.native_decode',\n"
        "        'tf_kaldi_speaker_tpu_torch.train.trainer_mi',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.extract_bnf',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.train_mi',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.extract_mi',\n"
        "        'tf_kaldi_speaker_tpu_torch.kio.transition_model',\n"
        "        'tf_kaldi_speaker_tpu_torch.multitask',\n"
        "        'tf_kaldi_speaker_tpu_torch.multitask.common',\n"
        "        'tf_kaldi_speaker_tpu_torch.multitask.data_v2',\n"
        "        'tf_kaldi_speaker_tpu_torch.multitask.model',\n"
        "        'tf_kaldi_speaker_tpu_torch.multitask.trainer',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.ali_to_pdf',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.train_mt',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.extract_mt',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.extract_mt_phone',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.compute_loglike',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.train_mt_lr_learning',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli._launch',\n"
        "        'tf_kaldi_speaker_tpu_torch.parallel',\n"
        "        'tf_kaldi_speaker_tpu_torch.parallel.distributed',\n"
        "        'tf_kaldi_speaker_tpu_torch.parallel.mesh',\n"
        "        'tf_kaldi_speaker_tpu_torch.parallel.sharding_rules',\n"
        "        'tf_kaldi_speaker_tpu_torch.parallel.sequence_parallel',\n"
        "        'tf_kaldi_speaker_tpu_torch.kio.fst',\n"
        "        'tf_kaldi_speaker_tpu_torch.backend.decoder',\n"
        "        'tf_kaldi_speaker_tpu_torch.backend.lattice',\n"
        "        'tf_kaldi_speaker_tpu_torch.backend.wer',\n"
        "        'tf_kaldi_speaker_tpu_torch.backend.arpa',\n"
        "        'tf_kaldi_speaker_tpu_torch.backend.lmrescore',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.decode_faster',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.lattice_best_path',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.lmrescore',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.compute_wer',\n"
        "        'tf_kaldi_speaker_tpu_torch.kio.tf_bundle',\n"
        "        'tf_kaldi_speaker_tpu_torch.train.tf_import',\n"
        "        'tf_kaldi_speaker_tpu_torch.train.tf_export',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.import_tf_checkpoint',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.export_tf_checkpoint',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.extract_softmax_weights',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.target_logit_curve',\n"
        "        'tf_kaldi_speaker_tpu_torch.cli.train_insight',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.corpora',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.common',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.quality_matrix',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.qmatrix_extra',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.synthetic',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.convergence',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.attention',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.ecapa',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.resnet',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.multitask',\n"
        "        'tf_kaldi_speaker_tpu_torch.validation.decoder_stress'} <= set(mods), mods\n"
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


RECIPES = {"voxceleb": "voxceleb/v1/run.sh", "fisher": "fisher/v1/run.sh",
           "fisher_v3_multitask": "fisher/v3_multitask/run.sh",
           "fisher_v3_multitask_decode": "fisher/v3_multitask/run_decode.sh",
           "sre": "sre/v1/run.sh"}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_copies_call_the_port_only(recipe):
    """Every line of a recipe copy that names a package calls a port CLI or
    runs a port recipe script, or, in an inline Python snippet, imports
    from the port."""
    with open(os.path.join(PORT, "recipes", RECIPES[recipe])) as f:
        lines = [line for line in f if "tf_kaldi_speaker_tpu" in line
                 and not line.lstrip().startswith("#")]
    assert lines and all("tf_kaldi_speaker_tpu_torch.cli." in line
                         or line.startswith("from tf_kaldi_speaker_tpu_torch.")
                         or "bash tf_kaldi_speaker_tpu_torch/recipes/" in line
                         for line in lines)
    assert not [line for line in lines if "tf_kaldi_speaker_tpu." in line]


def test_native_reader_is_built_from_the_port():
    """The port's native reader and WFST decoder compile the port's own
    sources into the checkout's build/ and never load the JAX package's
    libraries."""
    from tf_kaldi_speaker_tpu_torch.backend import decoder
    from tf_kaldi_speaker_tpu_torch.kio import native_decode

    assert os.path.dirname(native_decode.SOURCE) == os.path.join(PORT, "native")
    assert native_decode.WFST_SOURCE == os.path.join(PORT, "native", "wfst_decoder.cpp")
    with open(decoder.__file__) as f:
        assert "libwfstdecode" not in f.read()
    assert native_decode.BUILD_DIR == os.path.join(ROOT, "build", "tfks_torch_native")
    with open(native_decode.__file__) as f:
        assert "libarkdecode" not in f.read()


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
