#!/usr/bin/env bash
# Evaluate TUM RGB-D sequences (the reference's Examples/eval_tum_rgbd.sh
# loop) with the port's runner.
#   $1 = dataset root containing rgbd_dataset_freiburg{1,2,3}_* dirs
#   $2 = HF-Net weights .npz
#   $3 = a checkout of the upstream HFNet-SLAM project (its
#        Examples/RGB-D/TUM{1,2,3}.yaml settings)
# Each sequence dir holds rgb.txt, depth.txt and groundtruth.txt (the TUM
# RGB-D layout); the freiburg index picks TUM{1,2,3}.yaml.
# Run from the repository root; DEVICE=cpu runs on the CPU (default: CUDA).
set -euo pipefail
ROOT=${1:?dataset root}
WEIGHTS=${2:?weights .npz}
UPSTREAM=${3:?upstream HFNet-SLAM checkout}
OUT=${OUT:-tumrgbd_eval}
DEV=()
[ -n "${DEVICE:-}" ] && DEV=(--device "$DEVICE")
mkdir -p "$OUT"

for SEQ in "$ROOT"/rgbd_dataset_freiburg*; do
  [ -d "$SEQ" ] || continue
  NAME=$(basename "$SEQ")
  FR=$(echo "$NAME" | sed -E 's/.*freiburg([0-9]).*/\1/')
  CFG="$UPSTREAM/Examples/RGB-D/TUM${FR}.yaml"
  echo "=== $NAME ==="
  python3 -m hfnet_slam_torch.examples.run_tum_rgbd "$SEQ" --config "$CFG" \
      --weights "$WEIGHTS" --out "$OUT/${NAME}.txt" --gt "$SEQ/groundtruth.txt" "${DEV[@]}" \
      | tee "$OUT/${NAME}.log"
done
grep -h "ATE RMSE" "$OUT"/*.log || true
