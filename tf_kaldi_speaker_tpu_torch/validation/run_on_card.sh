#!/usr/bin/env bash
# The port's training-quality record on one card: the validation harnesses
# of tf_kaldi_speaker_tpu_torch.validation, several processes at once on
# the card (each run is host-paced), one log a run.
#
#   bash tf_kaldi_speaker_tpu_torch/validation/run_on_card.sh OUT [JOBS] [SETS...]
#
# SETS (default: required):
#   required  convergence: 7 families x seeds 1-3 in float32, am-softmax
#             bf16 and the flagship program x seeds 1-3, then `report`;
#             quality_matrix --paths for stream, pool, pool_bf16 and
#             pool_bf16_fused (3 seeds, one process an arm); the four
#             model-family validations; decoder_stress at its defaults
#   repeat    softmax (streaming, float32), mt_softmax and the flagship arm,
#             seed 1, twice more (OUT/conv_r1, conv_r2): are the valid
#             losses and the EER equal run to run? And the flagship arm
#             under --deterministic (OUT/conv_r1)
#   det       softmax and mt_softmax, seed 1, under --deterministic in
#             OUT/conv_r1 and OUT/conv_r2 (after repeat): equal run to run?
#   losses    quality_matrix --losses (5 seeds, one process a loss)
#   gap       quality_matrix --gap
#   rot       quality_matrix --paths for pool_rot_utts, pool_rot, pool_rot_c3
#
# Writes OUT/logs/<run>.log, OUT/rcs (a run's name and exit code a line),
# and OUT/convergence_report.txt. Exits 1 when any run failed.
set -u
out=${1:?usage: run_on_card.sh OUT [JOBS] [SETS...]}
jobs=${2:-4}
shift $(( $# >= 2 ? 2 : 1 ))
sets=${*:-required}
py=${PYTHON:-python3}
m=tf_kaldi_speaker_tpu_torch.validation
mkdir -p "$out/logs"
: > "$out/rcs"

# the kernels once, before the runs that load them
$py -c "from tf_kaldi_speaker_tpu_torch.ops import _build; _build.build(); _build.load()" \
  > "$out/logs/build.log" 2>&1 || { echo "build failed"; cat "$out/logs/build.log"; exit 1; }

list=$out/jobs
: > "$list"
job() { echo "$1|$2" >> "$list"; }
for s in $sets; do
  case $s in
    required)
      $py -m $m.convergence make-data --root "$out/conv" > "$out/logs/make_data.log" 2>&1
      $py -m $m.convergence make-data-mt --root "$out/conv" > "$out/logs/make_data_mt.log" 2>&1
      for seed in 1 2 3; do
        for loss in softmax amsoftmax asoftmax_m4 asoftmax_m1 arcsoftmax_m0.25 att_amsoftmax \
                    mt_softmax; do
          job "conv_${loss}_s$seed" "$m.convergence run --loss $loss --seed $seed --root $out/conv"
        done
        job "conv_amsoftmax_s${seed}_bf16" \
          "$m.convergence run --loss amsoftmax --seed $seed --compute-dtype bfloat16 --root $out/conv"
        job "conv_amsoftmax_s${seed}_flagship" \
          "$m.convergence run --loss amsoftmax --seed $seed --program flagship --root $out/conv"
      done
      for arm in stream pool pool_bf16 pool_bf16_fused; do
        job "qm_$arm" "$m.quality_matrix --paths --only $arm --root $out/qm_$arm"
      done
      for fam in attention ecapa resnet multitask; do
        job "$fam" "$m.$fam --root $out/$fam"
      done
      job decoder_stress "$m.decoder_stress --root $out"
      ;;
    repeat)
      for rep in 1 2; do
        r=$out/conv_r$rep
        $py -m $m.convergence make-data --root "$r" > /dev/null 2>&1
        $py -m $m.convergence make-data-mt --root "$r" > /dev/null 2>&1
        job "conv_amsoftmax_s1_flagship_r$rep" \
          "$m.convergence run --loss amsoftmax --seed 1 --program flagship --root $r"
        job "conv_softmax_s1_r$rep" "$m.convergence run --loss softmax --seed 1 --root $r"
        job "conv_mt_softmax_s1_r$rep" "$m.convergence run --loss mt_softmax --seed 1 --root $r"
      done
      job conv_amsoftmax_s1_flagship_det "$m.convergence run --loss amsoftmax --seed 1 \
--program flagship --deterministic --root $out/conv_r1"
      ;;
    det)
      for rep in 1 2; do
        for loss in softmax mt_softmax; do
          job "conv_${loss}_s1_det_r$rep" \
            "$m.convergence run --loss $loss --seed 1 --deterministic --root $out/conv_r$rep"
        done
      done
      ;;
    losses)
      for loss in softmax amsoftmax_m0.2 amsoftmax_m0.2_mhe0.01; do
        job "qm_loss_$loss" "$m.quality_matrix --losses --only $loss --root $out/qm_loss_$loss"
      done
      ;;
    gap) job qm_gap "$m.quality_matrix --gap --root $out/qm_gap" ;;
    rot)
      for arm in pool_rot_utts pool_rot pool_rot_c3; do
        job "qm_$arm" "$m.quality_matrix --paths --only $arm --root $out/qm_$arm"
      done
      ;;
    *) echo "unknown set $s"; exit 2 ;;
  esac
done

run_one() {
  local name=${1%%|*} cmd=${1#*|}
  local t0=$SECONDS
  # shellcheck disable=SC2086
  $py -m $cmd > "$out/logs/$name.log" 2>&1
  local rc=$?
  echo "$name $rc $((SECONDS - t0))" >> "$out/rcs"
}
export -f run_one
export out py
t0=$SECONDS
tr '\n' '\0' < "$list" | xargs -0 -P "$jobs" -I{} bash -c 'run_one "$1"' _ {}
echo "runs: $(wc -l < "$list") in $((SECONDS - t0)) s"
if [ -d "$out/conv/results" ]; then
  $py -m $m.convergence report --root "$out/conv" > "$out/convergence_report.txt" 2>&1
  echo "convergence_report $?" >> "$out/rcs"
fi
cat "$out/rcs"
! awk '$2 != 0 {bad = 1} END {exit !bad}' "$out/rcs"
