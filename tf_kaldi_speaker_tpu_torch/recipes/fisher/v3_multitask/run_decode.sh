#!/usr/bin/env bash
# Hybrid ASR decode recipe for the multitask phone head — the PyTorch port's
# copy of recipes/fisher/v3_multitask/run_decode.sh.
#
# The same steps, arguments and variables, through python -m
# tf_kaldi_speaker_tpu_torch.cli.*; one more variable: device (default cuda)
# is passed as --device to compute_loglike, the one step that runs the
# model (device=cpu decodes on the host). The decode, rescoring and WER
# CLIs run on the host and take no device.
#
# Equivalent of the reference nnet/run_decode.sh:77-91: pin the checkpoint,
# compute senone priors from the training alignments, dump per-split
# log-likelihood matrices with the phone head, then run lattice generation:
# Kaldi latgen-faster-mapped when installed, else the in-repo native WFST
# decoder (determinized CompactLattices). LM rescoring is native too: set
# oldarpa=/newarpa= and the lattices are rescored with cli.lmrescore (the
# lmrescore_const_arpa.sh replacement) before the scale sweep.
#
# Usage:
#   bash run_decode.sh <model_dir> <ali_dir> <graph_dir-or-"-"> \
#        <data1> [<data2> ...]
#   model_dir: trained multitask model (cli.train_mt output)
#   ali_dir:   pdf.ark/num_pdfs dir (for the senone prior)
#   graph_dir: Kaldi HCLG graph dir (needs HCLG.fst + words.txt);
#              pass "-" to stop after the loglike dump
#   dataN:     data dirs with feats.scp to decode
# Env overrides: checkpoint, acwt, beam, latbeam, oldarpa/newarpa (native
# ARPA LM rescoring of the generated lattices), and `mdl` — the Kaldi
# transition model latgen needs. Kaldi graph dirs do NOT contain final.mdl;
# by convention it lives one level up (exp/tri5a/graph -> exp/tri5a/
# final.mdl), which is the default here; set mdl= explicitly otherwise
# (e.g. the alignment dir's final.mdl used for ali-to-pdf).
set -euo pipefail

model=$1; ali_dir=$2; graph=$3; shift 3
checkpoint=${checkpoint:-"-1"}     # -1 = best (valid_loss), or 'last'/step
acwt=${acwt:-0.1}
beam=${beam:-13.0}
latbeam=${latbeam:-8.0}
oldarpa=${oldarpa:-}
newarpa=${newarpa:-}
# score.sh sweep knobs: word insertion penalties and the WER token filter
# (scripts/diagnostic/score.sh word_ins_penalty=0.0,0.5,1.0 + the
# wer_output_filter noise-token stripping).
wip=${wip:-0.0,0.5,1.0}
filter_words=${filter_words:-}
device=${device:-cuda}
if [ "$graph" != "-" ]; then
  mdl=${mdl:-$(dirname "$graph")/final.mdl}
fi
py="python -m"

echo "=== decode: pin checkpoint ($checkpoint)"
$py tf_kaldi_speaker_tpu_torch.cli.make_checkpoint --checkpoint "$checkpoint" "$model"

prior="$model/prior.vec"
if [ ! -f "$prior" ]; then
  echo "=== decode: senone prior from $ali_dir"
  python - "$ali_dir" "$prior" <<'EOF'
import sys, os
import numpy as np
from tf_kaldi_speaker_tpu_torch.kio import read_vec_int_ark
from tf_kaldi_speaker_tpu_torch.multitask import get_num_phones
ali_dir, out = sys.argv[1], sys.argv[2]
n = get_num_phones(ali_dir)
counts = np.ones(n)  # floor so unseen senones keep a finite log-prior
for _, ali in read_vec_int_ark(os.path.join(ali_dir, "pdf.ark")):
    counts += np.bincount(ali, minlength=n)
prior = counts / counts.sum()
with open(out, "w") as f:
    f.write("[ " + " ".join("%g" % p for p in prior) + " ]\n")
EOF
fi

for data in "$@"; do
  name=$(basename "$data")
  out="$model/decode_$name"
  mkdir -p "$out"
  echo "=== decode: log-likelihoods for $name"
  $py tf_kaldi_speaker_tpu_torch.cli.compute_loglike --device "$device" --prior "$prior" \
    "$model" "scp:$data/feats.scp" "ark:$out/loglike.ark"

  if [ "$graph" != "-" ] && command -v latgen-faster-mapped >/dev/null 2>&1; then
    echo "=== decode: latgen-faster-mapped for $name (mdl=$mdl)"
    latgen-faster-mapped \
      --acoustic-scale="$acwt" --beam="$beam" --lattice-beam="$latbeam" \
      --word-symbol-table="$graph/words.txt" \
      "$mdl" "$graph/HCLG.fst" \
      "ark:$out/loglike.ark" "ark:|gzip -c > $out/lat.1.gz"
    echo "    lattices in $out/lat.1.gz (score with Kaldi local/score.sh)"
  elif [ "$graph" != "-" ]; then
    # No Kaldi on the box: the in-repo WFST decoder (best path, native
    # C++ core) produces transcripts + alignments directly.
    echo "=== decode: native decode_faster for $name (mdl=$mdl)"
    $py tf_kaldi_speaker_tpu_torch.cli.decode_faster \
      --acoustic-scale "$acwt" --beam "$beam" \
      --lattice-out "$out/lat.txt" --lattice-beam "$latbeam" \
      --word-symbol-table "$graph/words.txt" --text-out "$out/text" \
      --align-out "ark:$out/ali.ark" \
      "$mdl" "$graph/HCLG.fst" \
      "ark:$out/loglike.ark" "ark:$out/words.ark"
    lat="$out/lat.txt"
    if [ -n "$newarpa" ]; then
      # Native lmrescore_const_arpa.sh: subtract the decoding LM, add the
      # rescoring LM (omit oldarpa to only add).
      echo "=== decode: ARPA LM rescore for $name"
      rescore_flags=(--new-arpa "$newarpa")
      [ -n "$oldarpa" ] && rescore_flags+=(--old-arpa "$oldarpa")
      $py tf_kaldi_speaker_tpu_torch.cli.lmrescore \
        --word-symbol-table "$graph/words.txt" --acoustic-scale "$acwt" \
        "${rescore_flags[@]}" "$lat" "$out/lat_rescored.txt"
      lat="$out/lat_rescored.txt"
    fi
    if [ -f "$data/text" ]; then
      filter_flags=()
      [ -n "$filter_words" ] && filter_flags=(--filter-words "$filter_words")
      $py tf_kaldi_speaker_tpu_torch.cli.compute_wer "${filter_flags[@]}" \
        "$data/text" "$out/text" | tee "$out/wer"
      # local/score.sh equivalent: sweep 1/lmwt x word-insertion-penalty
      # over the lattices and keep the best operating point (no re-decode).
      $py tf_kaldi_speaker_tpu_torch.cli.lattice_best_path \
        --sweep-lmwt 5:15 --word-ins-penalty "$wip" "${filter_flags[@]}" \
        --ref-text "$data/text" \
        --word-symbol-table "$graph/words.txt" \
        --text-out "$out/text.best" \
        "$lat" "ark:$out/words.best.ark" | tee "$out/wer.best"
    fi
  else
    echo "    no graph dir given; stopping after the loglike dump"
    echo "    ($out/loglike.ark feeds latgen-faster-mapped or"
    echo "     tf_kaldi_speaker_tpu_torch.cli.decode_faster)"
  fi
done
