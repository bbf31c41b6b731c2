#!/usr/bin/env bash
# NIST SRE x-vector recipe (8 kHz) — the PyTorch port's copy of
# recipes/sre/v1/run.sh, on one CUDA card.
#
# The same stages 0-8 and variables as recipes/sre/v1/run.sh, every stage
# through python -m tf_kaldi_speaker_tpu_torch.cli.*; the shipped
# recipes/sre/v1/nnet_conf/*.json configs are read in place (run from the
# repository root). One more variable: device (default cuda) is passed as
# --device to every CLI that takes one (device=cpu runs the recipe on the
# host).
#
# Mirrors the staged reference egs/sre/v1/run.sh: train on SRE04-08 + SWBD,
# score SRE10/SRE16 with a PLDA backend; SRE16 adds unsupervised PLDA
# adaptation on the unlabeled major-language partition (reference
# run.sh:447-470 → cli.score --adapt-scp).
# Inputs under $data_root: {swbd_sre,sre10_enroll,sre10_test,sre16_major,
# sre16_enroll,sre16_test}/wav.scp (+ utt2spk), trial files per eval set.
set -euo pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-99}
data_root=${data_root:-data}
exp=${exp:-exp_sre}
musan_root=${musan_root:-$data_root/musan}
rirs_root=${rirs_root:-$data_root/rirs}
aug_frac=${aug_frac:-0.25}
config=${config:-recipes/sre/v1/nnet_conf/tdnn_amsoftmax_m0.15.json}
model=${model:-$exp/xvector_sre}
device=${device:-cuda}
py="python -m"

if [ $stage -le 0 ] && [ $stop_stage -ge 0 ] && [ -d "$data_root/sre2004" ]; then
  # Mirrors the reference's executed stage 0 (run.sh:68-100): combine the
  # pre-prepared LDC corpus dirs, validate, fix. (The reference's own
  # make_* LDC assembly is commented out upstream and symlinked from an
  # installed Kaldi tree; bring per-corpus dirs shaped as in
  # docs/MIGRATION.md and this stage takes over from there.)
  echo "=== stage 0: combine SRE04-08 + SWBD corpus dirs"
  $py tf_kaldi_speaker_tpu_torch.cli.combine_data "$data_root/sre" \
    "$data_root/sre2004" "$data_root/sre2005_train" "$data_root/sre2005_test" \
    "$data_root/sre2006_train" "$data_root/sre2006_test" "$data_root/sre08"
  $py tf_kaldi_speaker_tpu_torch.cli.validate_data_dir --no-text --no-feats \
    "$data_root/sre"
  $py tf_kaldi_speaker_tpu_torch.cli.fix_data_dir "$data_root/sre"
  $py tf_kaldi_speaker_tpu_torch.cli.combine_data "$data_root/swbd" \
    "$data_root"/swbd2_phase{1,2,3}_train \
    "$data_root"/swbd_cellular{1,2}_train
  $py tf_kaldi_speaker_tpu_torch.cli.validate_data_dir --no-text --no-feats \
    "$data_root/swbd"
  $py tf_kaldi_speaker_tpu_torch.cli.fix_data_dir "$data_root/swbd"
  # training pool = SWBD + SRE (reference run.sh:120 combine at stage 1)
  $py tf_kaldi_speaker_tpu_torch.cli.combine_data "$data_root/swbd_sre" \
    "$data_root/swbd" "$data_root/sre"
fi

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  echo "=== stage 1: 23-dim 8 kHz MFCC + VAD"
  for name in swbd_sre sre16_major sre10_enroll sre10_test sre16_enroll sre16_test; do
    $py tf_kaldi_speaker_tpu_torch.cli.make_mfcc --compress --device "$device" \
      --sample-rate 8000 --num-ceps 23 --num-mel-bins 23 \
      --low-freq 20 --high-freq 3700 \
      "$data_root/$name/wav.scp" "$data_root/$name/mfcc"
    cp "$data_root/$name/utt2spk" "$data_root/$name/mfcc/utt2spk" 2>/dev/null || true
    $py tf_kaldi_speaker_tpu_torch.cli.compute_vad --device "$device" \
      "$data_root/$name/mfcc/feats.scp" "$data_root/$name/mfcc"
  done
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  echo "=== stage 2: MUSAN/RIRS augmentation (reference sre run.sh aug stages)"
  if [ ! -f "$musan_root/noise/wav.scp" ] || [ ! -f "$rirs_root/wav.scp" ]; then
    echo "    musan_root/rirs_root missing — SKIPPING augmentation"
  else
    $py tf_kaldi_speaker_tpu_torch.cli.augment_data --device "$device" --mode reverb --seed 1 \
      --keep-frac "$aug_frac" --aug-wav-scp "$rirs_root/wav.scp" \
      "$data_root/swbd_sre/wav.scp" "$data_root/swbd_sre/utt2spk" \
      "$data_root/swbd_sre_reverb"
    $py tf_kaldi_speaker_tpu_torch.cli.augment_data --device "$device" --mode noise --seed 2 \
      --keep-frac "$aug_frac" --snr 15:10:5:0 \
      --aug-wav-scp "$musan_root/noise/wav.scp" \
      "$data_root/swbd_sre/wav.scp" "$data_root/swbd_sre/utt2spk" \
      "$data_root/swbd_sre_noise"
    $py tf_kaldi_speaker_tpu_torch.cli.augment_data --device "$device" --mode music --seed 3 \
      --keep-frac "$aug_frac" --snr 15:10:8:5 \
      --aug-wav-scp "$musan_root/music/wav.scp" \
      "$data_root/swbd_sre/wav.scp" "$data_root/swbd_sre/utt2spk" \
      "$data_root/swbd_sre_music"
    $py tf_kaldi_speaker_tpu_torch.cli.augment_data --device "$device" --mode babble --seed 4 \
      --keep-frac "$aug_frac" --snr 20:17:15:13 --num-babble-choices 3:4:5:6:7 \
      --aug-wav-scp "$musan_root/speech/wav.scp" \
      "$data_root/swbd_sre/wav.scp" "$data_root/swbd_sre/utt2spk" \
      "$data_root/swbd_sre_babble"
    $py tf_kaldi_speaker_tpu_torch.cli.combine_data "$data_root/swbd_sre_aug" \
      "$data_root"/swbd_sre_{reverb,noise,music,babble}
    $py tf_kaldi_speaker_tpu_torch.cli.make_mfcc --compress --device "$device" \
      --sample-rate 8000 --num-ceps 23 --num-mel-bins 23 \
      --low-freq 20 --high-freq 3700 \
      "$data_root/swbd_sre_aug/wav.scp" "$data_root/swbd_sre_aug/mfcc"
    cp "$data_root/swbd_sre_aug/utt2spk" "$data_root/swbd_sre_aug/mfcc/utt2spk"
    $py tf_kaldi_speaker_tpu_torch.cli.compute_vad --device "$device" \
      "$data_root/swbd_sre_aug/mfcc/feats.scp" "$data_root/swbd_sre_aug/mfcc"
  fi
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  echo "=== stage 3: egs prep + filtering + split"
  $py tf_kaldi_speaker_tpu_torch.cli.prepare_feats --device "$device" \
    "$data_root/swbd_sre/mfcc" "$data_root/swbd_sre/egs"
  cp "$data_root/swbd_sre/mfcc/utt2spk" "$data_root/swbd_sre/egs/utt2spk"
  src="$data_root/swbd_sre/egs"
  if [ -f "$data_root/swbd_sre_aug/mfcc/feats.scp" ]; then
    $py tf_kaldi_speaker_tpu_torch.cli.prepare_feats --device "$device" \
      "$data_root/swbd_sre_aug/mfcc" "$data_root/swbd_sre_aug/egs"
    cp "$data_root/swbd_sre_aug/mfcc/utt2spk" "$data_root/swbd_sre_aug/egs/utt2spk"
    mkdir -p "$data_root/swbd_sre_combined"
    for f in feats.scp utt2num_frames utt2spk; do
      cat "$data_root/swbd_sre/egs/$f" "$data_root/swbd_sre_aug/egs/$f" \
        > "$data_root/swbd_sre_combined/$f"
    done
    src="$data_root/swbd_sre_combined"
  fi
  $py tf_kaldi_speaker_tpu_torch.cli.filter_egs_dir --min-len 200 --min-num-utts 8 \
    --valid-speakers 200 --valid-utts 5 \
    "$src" "$data_root/split"
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  echo "=== stage 4: train"
  $py tf_kaldi_speaker_tpu_torch.cli.train --device "$device" --config "$config" \
    "$data_root/split/train" "$data_root/split/train/spklist" \
    "$data_root/split/valid" "$data_root/split/train/spklist" \
    "$model"
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  echo "=== stage 5: extract embeddings"
  $py tf_kaldi_speaker_tpu_torch.cli.make_checkpoint --checkpoint -1 "$model"
  for name in swbd_sre sre16_major sre10_enroll sre10_test sre16_enroll sre16_test; do
    $py tf_kaldi_speaker_tpu_torch.cli.extract --device "$device" --cmvn --vad \
      "$model" "scp:$data_root/$name/mfcc/feats.scp" \
      "ark,scp:$exp/xvectors_$name.ark,$exp/xvectors_$name.scp"
  done
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  echo "=== stage 6: SRE10 PLDA scoring"
  $py tf_kaldi_speaker_tpu_torch.cli.score --backend plda \
    --enroll-scp "$exp/xvectors_sre10_enroll.scp" \
    --enroll-utt2spk "$data_root/sre10_enroll/utt2spk" \
    --test-scp "$exp/xvectors_sre10_test.scp" \
    --trials "$data_root/sre10_test/trials" \
    --train-scp "$exp/xvectors_swbd_sre.scp" \
    --train-utt2spk "$data_root/swbd_sre/mfcc/utt2spk" \
    --lda-dim 150 --scores "$exp/scores_sre10.txt"
fi

if [ $stage -le 7 ] && [ $stop_stage -ge 7 ]; then
  echo "=== stage 7: SRE16 PLDA scoring with domain adaptation"
  # Per-language splits (reference eval_plda_sre16.sh: pooled/tgl/yue):
  # pass every trials_<lang> file present next to the pooled list.
  subset_flags=()
  for lang in tgl yue; do
    if [ -f "$data_root/sre16_test/trials_$lang" ]; then
      subset_flags+=(--subset-trials "$lang=$data_root/sre16_test/trials_$lang")
    fi
  done
  $py tf_kaldi_speaker_tpu_torch.cli.score --backend plda \
    --enroll-scp "$exp/xvectors_sre16_enroll.scp" \
    --enroll-utt2spk "$data_root/sre16_enroll/utt2spk" \
    --test-scp "$exp/xvectors_sre16_test.scp" \
    --trials "$data_root/sre16_test/trials" \
    --train-scp "$exp/xvectors_swbd_sre.scp" \
    --train-utt2spk "$data_root/swbd_sre/mfcc/utt2spk" \
    --lda-dim 150 \
    --adapt-scp "$exp/xvectors_sre16_major.scp" \
    --adapt-within-scale 0.75 --adapt-between-scale 0.25 \
    "${subset_flags[@]}" \
    --scores "$exp/scores_sre16.txt"
fi

if [ $stage -le 8 ] && [ $stop_stage -ge 8 ]; then
  echo "=== stage 8: score calibration (beyond reference)"
  # Map raw PLDA scores to calibrated LLRs with linear logistic regression
  # trained on a labeled dev split, then report Cllr/minCllr and
  # actDCF-at-the-Bayes-threshold vs minDCF. Default dev = the SRE10 scores
  # (cross-corpus calibration); point dev_scores=/dev_trials= at a labeled
  # in-domain dev set when one exists.
  dev_scores=${dev_scores:-$exp/scores_sre10.txt}
  dev_trials=${dev_trials:-$data_root/sre10_test/trials}
  $py tf_kaldi_speaker_tpu_torch.cli.calibrate_scores \
    --dev-scores "$dev_scores" --dev-trials "$dev_trials" \
    --eval-scores "$exp/scores_sre16.txt" \
    --eval-trials "$data_root/sre16_test/trials" \
    --operating-point 0.01 --operating-point 0.001 \
    --calibrated-out "$exp/scores_sre16_cal.txt"
fi
