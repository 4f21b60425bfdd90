#!/bin/bash
# One leg of the flagship's long run (ROADMAP A2): seeds 0 and 1 of
# ``tools/learning_check.py --recipe flagship`` at once on one card, from step
# FIRST to STOP, each seed's state carried between legs packed by
# ``tools/ckpt_pack.py``.
#
#     bash tools/flagship_leg.sh FIRST STOP CARRY OUT [read]
#
# For each seed S, OUT/a2_sS is the run's directory. At FIRST > 0 it starts
# as a copy of CARRY/a2_sS, the OUT/a2_sS an earlier leg left, which holds
# the packed state state_FIRST.ckpt.xz; the call resumes from it with
# ``--continue-run``. "read" adds each seed's held-out reading at STOP
# (``--holdout-only``; it needs the checkpoint a call that reached STOP
# writes, with the bank's rows). Then each seed's newest checkpoint is packed
# to OUT/a2_sS/state_N.ckpt.xz, N its step (STOP, or less where the trainer's
# timeout cut the call), and the raw checkpoints and the older packed states
# are removed, so OUT holds two states at most.
#
# Environment: TRAIN_TIMEOUT, the seconds each trainer may run (3300);
# DEADLINE, the seconds from the start after which no reading or packing is
# begun (none); OUT_LIMIT, the bytes OUT may hold at the end (64 MiB): past
# it the packed states are removed, the rows and readings kept. Every step
# prints what it did; the last line is OUT's size in bytes.
set -u
FIRST=$1; STOP=$2; CARRY=$3; OUT=$4; READ=${5:-}
TRAIN_TIMEOUT=${TRAIN_TIMEOUT:-3300}
OUT_LIMIT=${OUT_LIMIT:-67108864}
ROOT=$(cd "$(dirname "$0")/.." && pwd)
T0=$(date +%s)
left() {  # seconds to DEADLINE, or a large number without one
  if [ -n "${DEADLINE:-}" ]; then echo $((DEADLINE - $(date +%s) + T0)); else echo 999999; fi
}
newest() {  # the checkpoint a call left in its directory
  ls -d "$1"/ckpt/final 2>/dev/null || ls -d "$1"/ckpt/step_* 2>/dev/null | sort -t_ -k2 -n | tail -1
}
step_of() {  # the step of a checkpoint newest() named
  case "$(basename "$1")" in final) echo "$STOP" ;; step_*) basename "$1" | cut -d_ -f2 ;; esac
}

mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
for S in 0 1; do
  D=$OUT/a2_s$S
  RES=()
  if [ "$FIRST" -gt 0 ]; then
    mkdir -p "$D"; cp -r "$CARRY/a2_s$S/." "$D/"
    RES=(--resume "$D/state_$FIRST.ckpt.xz" --continue-run)
  fi
  mkdir -p "$D"
  python3 "$ROOT/tools/learning_check.py" --recipe flagship --seed $S "${RES[@]}" \
    --stop-at "$STOP" --out "$D" --timeout "$TRAIN_TIMEOUT" \
    > "$D.call_$FIRST.out" 2> "$D.call_$FIRST.err" &
done
wait
echo "trained $FIRST -> $STOP in $(($(date +%s) - T0)) s"
for S in 0 1; do
  D=$OUT/a2_s$S
  tail -c 300 "$D.call_$FIRST.out"; echo; tail -c 800 "$D.call_$FIRST.err"
done

if [ -n "$READ" ]; then
  budget=$(($(left) - 90))
  if [ "$budget" -lt 240 ]; then
    echo "no held-out reading: $budget s left before the deadline"
  else
    for S in 0 1; do
      D=$OUT/a2_s$S
      python3 "$ROOT/tools/learning_check.py" --recipe flagship --seed $S --holdout-only \
        --resume "$(newest "$D")" --out "$D" --timeout $((budget - 30)) \
        > "$D.read.out" 2> "$D.read.err" &
    done
    wait
    echo "read at $STOP after $(($(date +%s) - T0)) s"
    for S in 0 1; do tail -c 300 "$OUT/a2_s$S.read.out"; echo; tail -c 800 "$OUT/a2_s$S.read.err"; done
  fi
fi

if [ "$(left)" -lt 90 ]; then
  echo "no packing: $(left) s left before the deadline"
else
  for S in 0 1; do
    D=$OUT/a2_s$S
    CK=$(newest "$D")
    [ -n "$CK" ] && python3 "$ROOT/tools/ckpt_pack.py" pack "$CK" \
      "$D/state_$(step_of "$CK").ckpt.xz" > "$D.pack.out" 2>&1 &
  done
  wait
fi
for S in 0 1; do
  D=$OUT/a2_s$S
  cat "$D.pack.out" 2>/dev/null
  CK=$(newest "$D")
  NEW=state_$(step_of "${CK:-final}").ckpt.xz
  if [ -n "$CK" ] && [ -s "$D/$NEW" ]; then
    find "$D" -maxdepth 1 -name 'state_*.ckpt.xz' ! -name "$NEW" -delete
  fi
  rm -rf "$D/ckpt"
  sha256sum "$D"/state_*.ckpt.xz 2>/dev/null
done
size=$(du -sb "$OUT" | cut -f1)
if [ "$size" -gt "$OUT_LIMIT" ]; then
  echo "OUT holds $size bytes, past $OUT_LIMIT: the packed states are removed"
  rm -f "$OUT"/a2_s*/state_*.ckpt.xz
  size=$(du -sb "$OUT" | cut -f1)
fi
echo "done in $(($(date +%s) - T0)) s"
echo "$size"
