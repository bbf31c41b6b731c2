#!/usr/bin/env bash
# VoxCeleb x-vector recipe — the PyTorch port's copy of
# recipes/voxceleb/v1/run.sh, on one CUDA card.
#
# The same stages 0-8 and variables as recipes/voxceleb/v1/run.sh, every
# stage through python -m tf_kaldi_speaker_tpu_torch.cli.*; the shipped
# recipes/voxceleb/v1/nnet_conf/*.json configs are read in place (run from
# the repository root). One more variable: device (default cuda) is passed
# as --device to every CLI that takes one; device=cpu runs the whole recipe
# on the host. Inputs expected under $data_root:
#   $data_root/{voxceleb1_dev,voxceleb2,voxceleb1_test}/wav.scp  (+ utt2spk)
#   $data_root/voxceleb1_test/trials   ("enroll test target|nontarget")
# Augmentation sources (reference run.sh:70-131):
#   $musan_root/{noise,music,speech}/wav.scp
#   $rirs_root/wav.scp     (simulated small+medium room RIRs)
set -euo pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-99}
data_root=${data_root:-data}
exp=${exp:-exp}
musan_root=${musan_root:-$data_root/musan}
rirs_root=${rirs_root:-$data_root/rirs}
# fraction of the train list augmented per mode; 4 modes x 0.25 ~= the
# reference's 1M-of-4M subsample (run.sh:118-121)
aug_frac=${aug_frac:-0.25}
config=${config:-recipes/voxceleb/v1/nnet_conf/tdnn_amsoftmax_m0.20_linear_bn_1e-2.json}
finetune_config=${finetune_config:-recipes/voxceleb/v1/nnet_conf/tdnn_amsoftmax_m0.20_linear_bn_1e-2_mhe0.01.json}
model=${model:-$exp/xvector_amsoftmax}
finetune_model=${finetune_model:-${model}_mhe0.01}
# stage 0 (optional): point these at distributed corpus trees to build the
# data dirs natively (reference run.sh:45-53 via local/make_voxceleb{1,2}.pl)
voxceleb1_root=${voxceleb1_root:-}
voxceleb2_root=${voxceleb2_root:-}
voxceleb1_trials=${voxceleb1_trials:-$voxceleb1_root/veri_test.txt}
device=${device:-cuda}
py="python -m"

if [ $stage -le 0 ] && [ $stop_stage -ge 0 ] && [ -n "$voxceleb1_root" ]; then
  echo "=== stage 0: corpus trees -> Kaldi data dirs (reference run.sh:45-53)"
  # voxceleb1_{train,test} + the official trials list
  $py tf_kaldi_speaker_tpu_torch.cli.make_voxceleb voxceleb1 \
    "$voxceleb1_root" "$data_root" --trials "$voxceleb1_trials"
  rm -rf "$data_root/voxceleb1_dev"
  mv "$data_root/voxceleb1_train" "$data_root/voxceleb1_dev"
  if [ -n "$voxceleb2_root" ]; then
    # train on ALL of VoxCeleb2 (dev + test), like the reference
    $py tf_kaldi_speaker_tpu_torch.cli.make_voxceleb voxceleb2 \
      "$voxceleb2_root" "$data_root" --part dev
    $py tf_kaldi_speaker_tpu_torch.cli.make_voxceleb voxceleb2 \
      "$voxceleb2_root" "$data_root" --part test
    $py tf_kaldi_speaker_tpu_torch.cli.combine_data "$data_root/voxceleb2" \
      "$data_root/voxceleb2_dev" "$data_root/voxceleb2_test"
  fi
fi

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  echo "=== stage 1: MFCC (30-dim, 16 kHz) + energy VAD"
  for name in voxceleb1_dev voxceleb2 voxceleb1_test; do
    $py tf_kaldi_speaker_tpu_torch.cli.make_mfcc --compress --device "$device" \
      --num-ceps 30 --num-mel-bins 30 --low-freq 20 --high-freq 7600 \
      "$data_root/$name/wav.scp" "$data_root/$name/mfcc"
    cp "$data_root/$name/utt2spk" "$data_root/$name/mfcc/utt2spk"
    $py tf_kaldi_speaker_tpu_torch.cli.compute_vad --device "$device" \
      "$data_root/$name/mfcc/feats.scp" "$data_root/$name/mfcc"
  done
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  echo "=== stage 2: MUSAN/RIRS augmentation (reference run.sh:70-131)"
  if [ ! -f "$musan_root/noise/wav.scp" ] || [ ! -f "$rirs_root/wav.scp" ]; then
    echo "    musan_root=$musan_root or rirs_root=$rirs_root missing — SKIPPING"
    echo "    (published EERs require this stage; point musan_root/rirs_root"
    echo "     at MUSAN and RIRS_NOISES wav.scp dirs and rerun --stage 2)"
  else
    # combined clean train wav list (reference run.sh:53 combine_data)
    $py tf_kaldi_speaker_tpu_torch.cli.combine_data "$data_root/train_wavs" \
      "$data_root/voxceleb1_dev" "$data_root/voxceleb2"
    # reference parameters: reverb = RIRs, no additive noise (run.sh:75-92);
    # noise fg SNRs 15:10:5:0; music bg 15:10:8:5; babble 20:17:15:13 with
    # 3-7 speech sources (run.sh:108-113)
    $py tf_kaldi_speaker_tpu_torch.cli.augment_data --mode reverb --device "$device" --seed 1 \
      --keep-frac "$aug_frac" --aug-wav-scp "$rirs_root/wav.scp" \
      "$data_root/train_wavs/wav.scp" "$data_root/train_wavs/utt2spk" \
      "$data_root/train_reverb"
    $py tf_kaldi_speaker_tpu_torch.cli.augment_data --mode noise --device "$device" --seed 2 \
      --keep-frac "$aug_frac" --snr 15:10:5:0 \
      --aug-wav-scp "$musan_root/noise/wav.scp" \
      "$data_root/train_wavs/wav.scp" "$data_root/train_wavs/utt2spk" \
      "$data_root/train_noise"
    $py tf_kaldi_speaker_tpu_torch.cli.augment_data --mode music --device "$device" --seed 3 \
      --keep-frac "$aug_frac" --snr 15:10:8:5 \
      --aug-wav-scp "$musan_root/music/wav.scp" \
      "$data_root/train_wavs/wav.scp" "$data_root/train_wavs/utt2spk" \
      "$data_root/train_music"
    $py tf_kaldi_speaker_tpu_torch.cli.augment_data --mode babble --device "$device" --seed 4 \
      --keep-frac "$aug_frac" --snr 20:17:15:13 --num-babble-choices 3:4:5:6:7 \
      --aug-wav-scp "$musan_root/speech/wav.scp" \
      "$data_root/train_wavs/wav.scp" "$data_root/train_wavs/utt2spk" \
      "$data_root/train_babble"
    # MFCC + VAD for the augmented copies (reference computes MFCC only and
    # reuses the clean vad.scp; our VAD is recomputed — equivalent energy VAD)
    $py tf_kaldi_speaker_tpu_torch.cli.combine_data "$data_root/train_aug" \
      "$data_root"/train_{reverb,noise,music,babble}
    $py tf_kaldi_speaker_tpu_torch.cli.make_mfcc --compress --device "$device" \
      --num-ceps 30 --num-mel-bins 30 --low-freq 20 --high-freq 7600 \
      "$data_root/train_aug/wav.scp" "$data_root/train_aug/mfcc"
    cp "$data_root/train_aug/utt2spk" "$data_root/train_aug/mfcc/utt2spk"
    $py tf_kaldi_speaker_tpu_torch.cli.compute_vad --device "$device" \
      "$data_root/train_aug/mfcc/feats.scp" "$data_root/train_aug/mfcc"
  fi
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  echo "=== stage 3: training egs prep (sliding CMVN + silence removal, compressed)"
  for name in voxceleb1_dev voxceleb2; do
    $py tf_kaldi_speaker_tpu_torch.cli.prepare_feats --device "$device" \
      "$data_root/$name/mfcc" "$data_root/$name/egs"
  done
  dirs="voxceleb1_dev/egs voxceleb2/egs"
  if [ -f "$data_root/train_aug/mfcc/feats.scp" ]; then
    $py tf_kaldi_speaker_tpu_torch.cli.prepare_feats --device "$device" \
      "$data_root/train_aug/mfcc" "$data_root/train_aug/egs"
    dirs="$dirs train_aug/egs"
  fi
  # merge clean (+ augmented) into one train dir
  mkdir -p "$data_root/train_combined"
  for f in feats.scp utt2num_frames utt2spk; do
    : > "$data_root/train_combined/$f"
    for d in $dirs; do cat "$data_root/$d/$f" >> "$data_root/train_combined/$f"; done
  done
  python - "$data_root/train_combined" <<'EOF'
import sys, collections, os
d = sys.argv[1]
spk2utt = collections.defaultdict(list)
for line in open(os.path.join(d, "utt2spk")):
    u, s = line.split()
    spk2utt[s].append(u)
with open(os.path.join(d, "spk2utt"), "w") as f:
    for s in sorted(spk2utt):
        f.write("%s %s\n" % (s, " ".join(sorted(spk2utt[s]))))
EOF
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  echo "=== stage 4: filter (min 200 frames, >=8 utts/spk) + valid split + spklist"
  $py tf_kaldi_speaker_tpu_torch.cli.filter_egs_dir --min-len 200 --min-num-utts 8 \
    --valid-speakers 200 --valid-utts 5 \
    "$data_root/train_combined" "$data_root/split"
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  echo "=== stage 5: train ($config)"
  $py tf_kaldi_speaker_tpu_torch.cli.train --device "$device" --config "$config" \
    "$data_root/split/train" "$data_root/split/train/spklist" \
    "$data_root/split/valid" "$data_root/split/train/spklist" \
    "$model"
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  echo "=== stage 6: fine-tune from the pretrained model (reference run.sh:430-444)"
  $py tf_kaldi_speaker_tpu_torch.cli.finetune --device "$device" --config "$finetune_config" \
    --pretrain_model "$model" --checkpoint last \
    "$data_root/split/train" "$data_root/split/train/spklist" \
    "$data_root/split/valid" "$data_root/split/train/spklist" \
    "$finetune_model"
fi

if [ $stage -le 7 ] && [ $stop_stage -ge 7 ]; then
  echo "=== stage 7: extract embeddings (best checkpoint, batched on the card)"
  eval_model=$finetune_model
  [ -d "$eval_model/nnet" ] || eval_model=$model
  $py tf_kaldi_speaker_tpu_torch.cli.make_checkpoint --checkpoint -1 "$eval_model"
  # test set: raw MFCC through the CMVN+VAD pipe (reference
  # run_extract_embeddings.sh:47); train_combined: its egs features are
  # ALREADY CMVN'd + silence-removed, so no flags (re-applying energy VAD
  # to zero-mean features would drop every frame).
  $py tf_kaldi_speaker_tpu_torch.cli.extract --cmvn --vad --device "$device" \
    "$eval_model" "scp:$data_root/voxceleb1_test/mfcc/feats.scp" \
    "ark,scp:$exp/xvectors_voxceleb1_test.ark,$exp/xvectors_voxceleb1_test.scp"
  $py tf_kaldi_speaker_tpu_torch.cli.extract --device "$device" \
    "$eval_model" "scp:$data_root/train_combined/feats.scp" \
    "ark,scp:$exp/xvectors_train_combined.ark,$exp/xvectors_train_combined.scp"
fi

if [ $stage -le 8 ] && [ $stop_stage -ge 8 ]; then
  echo "=== stage 8: scoring (cosine and PLDA) + EER/minDCF"
  $py tf_kaldi_speaker_tpu_torch.cli.score --backend cosine \
    --enroll-scp "$exp/xvectors_voxceleb1_test.scp" \
    --test-scp "$exp/xvectors_voxceleb1_test.scp" \
    --trials "$data_root/voxceleb1_test/trials" \
    --scores "$exp/scores_cosine.txt"
  $py tf_kaldi_speaker_tpu_torch.cli.score --backend plda \
    --enroll-scp "$exp/xvectors_voxceleb1_test.scp" \
    --test-scp "$exp/xvectors_voxceleb1_test.scp" \
    --trials "$data_root/voxceleb1_test/trials" \
    --train-scp "$exp/xvectors_train_combined.scp" \
    --train-utt2spk "$data_root/train_combined/utt2spk" \
    --lda-dim 200 \
    --scores "$exp/scores_plda.txt"
fi
