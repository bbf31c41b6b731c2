"""Every CLI of the port that takes ``--device`` turns TF32 off.

PyTorch lets cuDNN run float32 convolutions in TF32 by default, which puts a
float32 model's outputs on the card outside the port's parity bounds
against the CPU. Each case sets both flags True, runs the CLI with
``--device cpu`` on inputs that do not exist (so it stops right after its
set-up), and checks that the CLI's device set-up left both flags False.
The flags can be set on a CPU build of torch.
"""

import argparse
import glob
import importlib
import os

import pytest
import torch

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tf_kaldi_speaker_tpu_torch")


def _device_clis():
    out = []
    for path in sorted(glob.glob(os.path.join(PORT, "cli", "*.py"))):
        with open(path) as f:
            if '"--device"' in f.read():
                out.append(os.path.splitext(os.path.basename(path))[0])
    return out


DEVICE_CLIS = _device_clis()


def test_the_model_clis_take_a_device():
    want = {"extract", "serve", "train", "finetune", "train_lr_learning", "train_mi",
            "train_mt", "train_mt_lr_learning", "extract_bnf", "extract_mi", "extract_mt",
            "extract_mt_phone", "compute_loglike", "compute_gae2e_loss", "make_mfcc",
            "compute_vad", "prepare_feats", "augment_data", "import_tf_checkpoint",
            "target_logit_curve", "train_insight"}
    assert want <= set(DEVICE_CLIS)


def _argv(mod, missing, monkeypatch):
    """``--device cpu`` and a missing path (or the first choice, or 1 where
    the option takes an int) for every positional and every required option
    of ``mod``'s parser."""
    actions = []

    def collect(self, args=None, namespace=None):
        actions.extend(self._actions)
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", collect)
        with pytest.raises(SystemExit):
            mod.main([])
    argv = ["--device", "cpu"]
    for a in actions:
        value = a.choices[0] if a.choices else "1" if a.type is int else missing
        if a.option_strings and a.required:
            argv += [a.option_strings[0], value]
        elif not a.option_strings and a.nargs not in ("*", "?"):
            argv.append(value)
    return argv


@pytest.mark.parametrize("name", DEVICE_CLIS)
def test_cli_device_setup_turns_tf32_off(name, tmp_path, monkeypatch):
    mod = importlib.import_module("tf_kaldi_speaker_tpu_torch.cli." + name)
    # under a directory that does not exist: a CLI without inputs
    # (target_logit_curve) fails to write there
    argv = _argv(mod, str(tmp_path / "absent" / "missing"), monkeypatch)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(Exception):  # the inputs do not exist
            mod.main(argv)
        assert torch.backends.cuda.matmul.allow_tf32 is False, name
        assert torch.backends.cudnn.allow_tf32 is False, name
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
