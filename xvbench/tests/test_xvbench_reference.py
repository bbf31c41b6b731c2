"""The plain reference against the port on the CPU at a tiny width: its
codec and sampler against the port's reader and pool, and, through the
traffic driver's comparison with the configuration in float32, the port's
checked steps against the reference's."""

import random

import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu_torch.data.device_pool import DevicePool
from tf_kaldi_speaker_tpu_torch.kio import decode_cm_codes, read_codes_scp
from xvbench import control, corpus
from xvbench.reference import codec, sampler
from xvbench.tests import tiny

SPEC = {"dim": 30, "lengths": {"kind": "even", "min": 390, "max": 700}, "stored_per_speaker": 2}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return corpus.generate(SPEC, 6, 4, 2 ** 31 + 99, str(tmp_path_factory.mktemp("corpus")))


def test_codec_equals_the_ports_reader(small):
    for i, (key, codes, headers) in enumerate(read_codes_scp(small.scp)):
        assert key == small.keys[i]
        np.testing.assert_array_equal(codes, small.utt_codes(i))
        p = codec.percentiles(small.headers_u16[i], corpus.GLOBAL_MIN, corpus.GLOBAL_RANGE)
        np.testing.assert_array_equal(p.T, headers)
        np.testing.assert_array_equal(codec.decode(small.utt_codes(i), p),
                                      decode_cm_codes(codes, headers))
    assert i + 1 == 24


def test_utterances_share_their_speakers_stored_matrices(small):
    """Utterance j of a speaker reads its matrix j mod 2: a speaker's
    utterances 0 and 2 are one matrix, 0 and 1 two."""
    for s in range(6):
        a, b, c = (4 * s + j for j in range(3))
        assert small.starts[a] == small.starts[c] != small.starts[b]
        assert small.lengths[a] == small.lengths[c]
    assert small.codes.size == 30 * int(small.lengths.reshape(6, 4)[:, :2].sum())


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
@pytest.mark.parametrize("length", [200, 392])
def test_sampler_equals_the_ports_pool(small, length, seed):
    pool = DevicePool(small.data_dir, small.spklist, device="cpu", seed=seed)
    pool.stage(0)
    index = sampler.PoolIndex(small.labels, small.lengths)
    starts, utts, labels = pool.sample_group(random.Random(7), 3, 4, 2, length)
    ref = index.sample_group(random.Random(7), 3, 4, 2, length)
    for k, rows in enumerate(ref):
        assert [u for u, _, _ in rows] == utts[k].tolist()
        assert [lab for _, _, lab in rows] == labels[k].tolist()
        assert [int(pool.utt_offset[u]) + s for u, s, _ in rows] == starts[k].tolist()
    pool.close()


# float32 rounding: the TDNN's first step's loss and gradient agree to a
# few 1e-6. Over the nine checked steps float32 differences grow at this
# width: the reference against itself from weights nudged by 1e-7 parts
# the change after the steps by up to 0.0084 in its worst leaf and 0.00063
# in its median one (three seeds), the port by 0.0071-0.012 and
# 0.00045-0.0014.
FLOAT32 = {"first_loss_gap": 1e-5, "grad_norm_gap": 1e-4, "update_norm_gap": 3e-2,
           "median_update_gap": 5e-3}


def test_port_in_float32_matches_the_reference():
    """In float32 the port and the reference compute the same steps, to
    float32 rounding."""
    cell = "tdnn_pool_train_b256"
    numbers = control.reading(cell, 12345, "program", torch.device("cpu"),
                              tiny.overrides(cell, compute_dtype="float32"))
    assert {k: numbers[k] < bound for k, bound in FLOAT32.items()} == {
        k: True for k in FLOAT32}, numbers
