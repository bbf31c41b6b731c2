"""Speaker metadata index over a Kaldi data directory.

A copy of ``tf_kaldi_speaker_tpu/data/speaker_index.py`` (reference
dataset/data_loader.py:14-110, get_speaker_info / get_aux_speaker_info):
spklist + spk2utt + feats.scp become spk2features / features2spk /
spk2index maps. Segment strings are "utt filename:offset" exactly as in
feats.scp. ``tests/test_torch_pool.py`` holds it equal to the original.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


def get_speaker_info(
    data: str, spklist: str
) -> Tuple[Dict[int, List[str]], Dict[str, int], Dict[str, int]]:
    assert os.path.isdir(data) and os.path.isfile(spklist)
    spk2index: Dict[str, int] = {}
    with open(spklist) as f:
        for line in f:
            spk, index = line.strip().split(" ")
            spk2index[spk] = int(index)

    utt2spk: Dict[str, int] = {}
    with open(os.path.join(data, "spk2utt")) as f:
        for line in f:
            spk, utts = line.strip().split(" ", 1)
            for utt in utts.split(" "):
                utt2spk[utt] = spk2index[spk]

    spk2features: Dict[int, List[str]] = {}
    features2spk: Dict[str, int] = {}
    with open(os.path.join(data, "feats.scp")) as f:
        for line in f:
            key, rxfile = line.strip().split(" ")
            spk = utt2spk[key]
            seg = key + " " + rxfile
            spk2features.setdefault(spk, []).append(seg)
            features2spk[seg] = spk
    return spk2features, features2spk, spk2index


def get_aux_speaker_info(
    data: str, aux_data: Dict[str, str], spklist: str
) -> Tuple[Dict[int, List[Dict[str, str]]], Dict[str, int], Dict[str, int]]:
    """Like get_speaker_info, plus named auxiliary feature directories.

    spk2features[spk] is a list of dicts; the main feature sits under key
    "features" and each aux stream under its own name.
    """
    assert os.path.isdir(data) and os.path.isfile(spklist)
    spk2index: Dict[str, int] = {}
    with open(spklist) as f:
        for line in f:
            spk, index = line.strip().split(" ")
            spk2index[spk] = int(index)

    utt2spk: Dict[str, int] = {}
    with open(os.path.join(data, "spk2utt")) as f:
        for line in f:
            spk, utts = line.strip().split(" ", 1)
            for utt in utts.split(" "):
                utt2spk[utt] = spk2index[spk]

    aux_utt2features: Dict[str, Dict[str, str]] = {}
    for name, aux_dir in aux_data.items():
        with open(os.path.join(aux_dir, "feats.scp")) as f:
            for line in f:
                key, rxfile = line.strip().split(" ")
                aux_utt2features.setdefault(key, {})[name] = key + " " + rxfile

    spk2features: Dict[int, List[Dict[str, str]]] = {}
    features2spk: Dict[str, int] = {}
    with open(os.path.join(data, "feats.scp")) as f:
        for line in f:
            key, rxfile = line.strip().split(" ")
            spk = utt2spk[key]
            seg = key + " " + rxfile
            features2spk[seg] = spk
            aux_utt2features.setdefault(key, {})["features"] = seg
            spk2features.setdefault(spk, []).append(aux_utt2features[key])
    return spk2features, features2spk, spk2index
