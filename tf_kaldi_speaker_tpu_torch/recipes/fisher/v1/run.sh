#!/usr/bin/env bash
# Fisher x-vector recipe (8 kHz, enroll/test protocol) — the PyTorch port's
# copy of recipes/fisher/v1/run.sh, on one CUDA card.
#
# The same stages 1-7 and variables as recipes/fisher/v1/run.sh, every stage
# through python -m tf_kaldi_speaker_tpu_torch.cli.*; the shipped
# recipes/fisher/v1/nnet_conf/*.json configs are read in place (run from the
# repository root). More variables: device (default cuda) is passed as
# --device to every CLI that takes one (device=cpu runs the recipe on the
# host), and stage 2's filter numbers (min_len 150, min_num_utts 5,
# valid_speakers 200, valid_utts 5) may be set smaller for a small corpus.
#
# Mirrors the staged reference egs/fisher/v1/run.sh: hires-MFCC egs prep
# with silence removal, min-length 150 / min-utts 5 filtering (run.sh:50-66),
# x-vector training, enrollment-speaker-mean extraction, and both PLDA
# (LDA dim 150, run.sh:230-252) and cosine (run.sh:286-293) scoring of the
# enroll-vs-test trial list.
# Inputs under $data_root: {train_background,enroll,test}/wav.scp (+ utt2spk)
# and $data_root/test/trials ("enrollspk testutt target|nontarget").
set -euo pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-99}
data_root=${data_root:-data}
exp=${exp:-exp_fisher_v1}
config=${config:-recipes/fisher/v1/nnet_conf/tdnn_amsoftmax_m0.20_linear_bn_1e-2.json}
model=${model:-$exp/xvector_fisher}
lda_dim=${lda_dim:-150}
# Embedding node: the reference extracts attention models at tdnn6_dense and
# margin models at "output" (run.sh:225/:288 --node); empty = the config's
# embedding_node.
node=${node:-}
# Background set used for mean/LDA/PLDA estimation; the reference keeps a
# separate train_background-ivector set (run.sh:222-252) — point plda_data
# at it when available, else the training background is reused.
plda_data=${plda_data:-train_background}
checkpoint=${checkpoint:-last}
min_len=${min_len:-150}
min_num_utts=${min_num_utts:-5}
valid_speakers=${valid_speakers:-200}
valid_utts=${valid_utts:-5}
device=${device:-cuda}
py="python -m"

# Config sweep: the reference's stage-3 block enumerates softmax / A-softmax
# (m=1,2,4) / AM-softmax (m=0.10..0.45) / Arc-softmax (m=0.10..0.40) /
# attention variants, one nnet_conf json each, training one at a time.
# Any of those jsons runs unchanged here:
#   config=recipes/fisher/v1/nnet_conf/<name>.json model=$exp/xvector_<name> \
#     stage=3 stop_stage=3 bash tf_kaldi_speaker_tpu_torch/recipes/fisher/v1/run.sh

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  echo "=== stage 1: 8 kHz MFCC + VAD"
  # Include a separate plda_data set in the prep loop so stage 4's
  # extraction finds its features.
  extra=""
  [ "$plda_data" != "train_background" ] && extra="$plda_data"
  for name in train_background enroll test $extra; do
    $py tf_kaldi_speaker_tpu_torch.cli.make_mfcc --compress --device "$device" \
      --sample-rate 8000 --num-ceps 23 --num-mel-bins 23 \
      --low-freq 20 --high-freq 3700 \
      "$data_root/$name/wav.scp" "$data_root/$name/mfcc"
    cp "$data_root/$name/utt2spk" "$data_root/$name/mfcc/utt2spk"
    $py tf_kaldi_speaker_tpu_torch.cli.compute_vad --device "$device" \
      "$data_root/$name/mfcc/feats.scp" "$data_root/$name/mfcc"
    # Restore data-dir invariants (reference fix_data_dir after each prep)
    $py tf_kaldi_speaker_tpu_torch.cli.fix_data_dir "$data_root/$name/mfcc"
  done
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  echo "=== stage 2: egs prep + filter (min $min_len frames, >=$min_num_utts utts/spk) + split"
  $py tf_kaldi_speaker_tpu_torch.cli.prepare_feats --device "$device" \
    "$data_root/train_background/mfcc" "$data_root/train_background/egs"
  $py tf_kaldi_speaker_tpu_torch.cli.fix_data_dir "$data_root/train_background/egs"
  $py tf_kaldi_speaker_tpu_torch.cli.filter_egs_dir --min-len "$min_len" \
    --min-num-utts "$min_num_utts" --valid-speakers "$valid_speakers" --valid-utts "$valid_utts" \
    "$data_root/train_background/egs" "$data_root/split"
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  echo "=== stage 3: train ($config)"
  $py tf_kaldi_speaker_tpu_torch.cli.train --device "$device" --config "$config" \
    "$data_root/split/train" "$data_root/split/train/spklist" \
    "$data_root/split/valid" "$data_root/split/train/spklist" \
    "$model"
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  echo "=== stage 4: extract embeddings (background for PLDA, enroll, test)"
  $py tf_kaldi_speaker_tpu_torch.cli.make_checkpoint --checkpoint "$checkpoint" "$model"
  node_flag=""
  [ -n "$node" ] && node_flag="--node $node"
  for name in $plda_data enroll test; do
    $py tf_kaldi_speaker_tpu_torch.cli.extract --cmvn --vad --device "$device" $node_flag \
      "$model" "scp:$data_root/$name/mfcc/feats.scp" \
      "ark,scp:$exp/xvectors_$name.ark,$exp/xvectors_$name.scp"
  done
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  echo "=== stage 5: PLDA scoring (LDA dim $lda_dim; reference run.sh:230-252)"
  $py tf_kaldi_speaker_tpu_torch.cli.score --backend plda \
    --enroll-scp "$exp/xvectors_enroll.scp" \
    --enroll-utt2spk "$data_root/enroll/utt2spk" \
    --test-scp "$exp/xvectors_test.scp" \
    --trials "$data_root/test/trials" \
    --train-scp "$exp/xvectors_$plda_data.scp" \
    --train-utt2spk "$data_root/$plda_data/mfcc/utt2spk" \
    --lda-dim "$lda_dim" \
    --scores "$exp/scores_plda.txt"
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  echo "=== stage 6: cosine scoring with speaker-mean enrollment (run.sh:286-293)"
  $py tf_kaldi_speaker_tpu_torch.cli.score --backend cosine \
    --enroll-scp "$exp/xvectors_enroll.scp" \
    --enroll-utt2spk "$data_root/enroll/utt2spk" \
    --test-scp "$exp/xvectors_test.scp" \
    --trials "$data_root/test/trials" \
    --scores "$exp/scores_cosine.txt"
fi

if [ $stage -le 7 ] && [ $stop_stage -ge 7 ]; then
  echo "=== stage 7: LDA + cosine scoring (run.sh:265-273 test_lda_cos)"
  $py tf_kaldi_speaker_tpu_torch.cli.score --backend cosine --lda-dim "$lda_dim" \
    --enroll-scp "$exp/xvectors_enroll.scp" \
    --enroll-utt2spk "$data_root/enroll/utt2spk" \
    --test-scp "$exp/xvectors_test.scp" \
    --trials "$data_root/test/trials" \
    --train-scp "$exp/xvectors_$plda_data.scp" \
    --train-utt2spk "$data_root/$plda_data/mfcc/utt2spk" \
    --scores "$exp/scores_lda_cosine.txt"
fi
