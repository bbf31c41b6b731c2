#!/usr/bin/env bash
# Fisher multitask (speaker + phone) recipe — the PyTorch port's copy of
# recipes/fisher/v3_multitask/run.sh, on one CUDA card.
#
# The same stages and variables as recipes/fisher/v3_multitask/run.sh,
# through python -m tf_kaldi_speaker_tpu_torch.cli.*; the shipped
# recipes/fisher/v3_multitask/nnet_conf/mt_softmax.json is read in place
# (run from the repository root). One more variable: device (default cuda)
# is passed as --device to every CLI that takes one (device=cpu runs the
# recipe on the host). Stage 6 runs the port's copy of the decode recipe,
# run_decode.sh beside this file, over graph_dir (HCLG.fst + words.txt;
# "-" or unset stops after the loglike dump).
#
# Mirrors the staged reference egs/fisher/v3/run_v1.sh: joint x-vector +
# senone training on features that KEEP silence (so alignments stay
# frame-aligned, scripts/prepare_feats_for_multitask_egs.sh), speaker and
# phone embedding extraction, and log-likelihood dumps for hybrid ASR
# decoding (reference run_v1.sh:244-250).
# Inputs: $data_root/fisher/{wav.scp,utt2spk}; alignments (pdf.ark/scp +
# num_pdfs) from a Kaldi tri5a alignment converted with ali-to-pdf.
set -euo pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-99}
data_root=${data_root:-data}
ali_dir=${ali_dir:-$data_root/fisher_ali}
# a raw Kaldi GMM alignment dir (final.mdl + ali.*.gz); when set, stage 2
# converts it to pdf.ark natively (no Kaldi ali-to-pdf / tree-info needed)
kaldi_ali_src=${kaldi_ali_src:-}
exp=${exp:-exp_fisher}
config=${config:-recipes/fisher/v3_multitask/nnet_conf/mt_softmax.json}
model=${model:-$exp/mt_xvector}
device=${device:-cuda}
py="python -m"

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  echo "=== stage 1: 8 kHz MFCC + VAD"
  $py tf_kaldi_speaker_tpu_torch.cli.make_mfcc --compress --device "$device" \
    --sample-rate 8000 --num-ceps 23 --num-mel-bins 23 \
    --low-freq 20 --high-freq 3700 \
    "$data_root/fisher/wav.scp" "$data_root/fisher/mfcc"
  cp "$data_root/fisher/utt2spk" "$data_root/fisher/mfcc/utt2spk"
  $py tf_kaldi_speaker_tpu_torch.cli.compute_vad --device "$device" \
    "$data_root/fisher/mfcc/feats.scp" "$data_root/fisher/mfcc"
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  echo "=== stage 2: CMVN egs KEEPING silence (alignment stays frame-aligned)"
  if [ -n "$kaldi_ali_src" ]; then
    echo "    converting Kaldi transition-id alignments -> pdf ids (native ali-to-pdf)"
    mkdir -p "$ali_dir"
    $py tf_kaldi_speaker_tpu_torch.cli.ali_to_pdf \
      --num-pdfs-out "$ali_dir/num_pdfs" \
      "$kaldi_ali_src/final.mdl" \
      "ark:gunzip -c $kaldi_ali_src/ali.*.gz |" \
      "ark,scp:$ali_dir/pdf.ark,$ali_dir/pdf.scp"
  fi
  $py tf_kaldi_speaker_tpu_torch.cli.prepare_feats --keep-silence --device "$device" \
    "$data_root/fisher/mfcc" "$data_root/fisher/egs"
  cp "$data_root/fisher/mfcc/utt2spk" "$data_root/fisher/egs/utt2spk"
  cp "$data_root/fisher/mfcc/vad.scp" "$data_root/fisher/egs/vad.scp" 2>/dev/null || true
  $py tf_kaldi_speaker_tpu_torch.cli.filter_egs_dir --min-len 200 --min-num-utts 4 \
    --valid-speakers 100 --valid-utts 4 \
    "$data_root/fisher/egs" "$data_root/split"
  for d in train valid; do
    cp "$data_root/fisher/mfcc/vad.scp" "$data_root/split/$d/vad.scp"
  done
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  echo "=== stage 3: multitask training (speaker + senone heads)"
  $py tf_kaldi_speaker_tpu_torch.cli.train_mt --device "$device" --config "$config" \
    "$data_root/split/train" "$ali_dir" "$data_root/split/train/spklist" \
    "$data_root/split/valid" "$ali_dir" "$data_root/split/train/spklist" \
    "$model"
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  echo "=== stage 4: speaker + phone embedding extraction"
  $py tf_kaldi_speaker_tpu_torch.cli.make_checkpoint --checkpoint -1 "$model"
  $py tf_kaldi_speaker_tpu_torch.cli.extract_mt --device "$device" \
    "$model" "scp:$data_root/split/train/feats.scp" \
    "ark,scp:$exp/xvectors_train.ark,$exp/xvectors_train.scp"
  $py tf_kaldi_speaker_tpu_torch.cli.extract_mt_phone --device "$device" \
    "$model" "scp:$data_root/split/valid/feats.scp" "ark:$exp/phone_post.ark"
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  echo "=== stage 5: log-likelihoods for ASR decoding (latgen input)"
  # prior.vec: normalized senone counts from the alignments
  python - "$ali_dir" "$exp/prior.vec" <<'PRIOR'
import sys
from tf_kaldi_speaker_tpu_torch.kio import read_vec_int_ark
from tf_kaldi_speaker_tpu_torch.multitask import get_num_phones
import numpy as np, os
ali_dir, out = sys.argv[1], sys.argv[2]
n = get_num_phones(ali_dir)
counts = np.ones(n)  # floor
for _, ali in read_vec_int_ark(os.path.join(ali_dir, "pdf.ark")):
    counts += np.bincount(ali, minlength=n)
prior = counts / counts.sum()
with open(out, "w") as f:
    f.write("[ " + " ".join("%g" % p for p in prior) + " ]\n")
PRIOR
  $py tf_kaldi_speaker_tpu_torch.cli.compute_loglike --device "$device" --prior "$exp/prior.vec" \
    "$model" "scp:$data_root/split/valid/feats.scp" "ark:$exp/loglike.ark"
  echo "feed $exp/loglike.ark to latgen-faster-mapped for decoding"
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  echo "=== stage 6: full decode driver (checkpoint pin + loglike + latgen when present)"
  device="$device" bash tf_kaldi_speaker_tpu_torch/recipes/fisher/v3_multitask/run_decode.sh \
    "$model" "$ali_dir" "${graph_dir:--}" "$data_root/split/valid"
fi
