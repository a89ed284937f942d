#!/usr/bin/env bash
# Evaluate all EuRoC machine-hall sequences, monocular and mono-inertial
# (the reference's Examples/eval_euroc.sh loop) with the port's runners.
#   $1 = dataset root containing MH_01_easy/ ... MH_05_difficult/
#   $2 = HF-Net weights .npz (the reference's flat format)
#   $3 = a checkout of the upstream HFNet-SLAM project: its
#        Examples/Monocular{,-Inertial}/EuRoC.yaml settings and the left-cam
#        ground truths under evaluation/Ground_truth/EuRoC_left_cam/
# Run from the repository root; DEVICE=cpu runs on the CPU (default: CUDA).
set -euo pipefail
ROOT=${1:?dataset root}
WEIGHTS=${2:?weights .npz}
UPSTREAM=${3:?upstream HFNet-SLAM checkout}
GT_DIR=$UPSTREAM/evaluation/Ground_truth/EuRoC_left_cam
OUT=${OUT:-euroc_eval}
DEV=()
[ -n "${DEVICE:-}" ] && DEV=(--device "$DEVICE")
mkdir -p "$OUT"

for SEQ in MH_01_easy MH_02_easy MH_03_medium MH_04_difficult MH_05_difficult; do
  SHORT=$(echo "$SEQ" | cut -d_ -f1,2 | tr -d _)   # MH01 ...
  GT="$GT_DIR/${SHORT}_GT.txt"
  echo "=== $SEQ (mono) ==="
  python3 -m hfnet_slam_torch.examples.run_euroc "$ROOT/$SEQ/mav0" \
      --config "$UPSTREAM/Examples/Monocular/EuRoC.yaml" --weights "$WEIGHTS" \
      --out "$OUT/${SHORT}_mono.txt" --gt "$GT" "${DEV[@]}" | tee "$OUT/${SHORT}_mono.log"
  echo "=== $SEQ (mono-inertial) ==="
  python3 -m hfnet_slam_torch.examples.run_euroc_inertial "$ROOT/$SEQ/mav0" \
      --config "$UPSTREAM/Examples/Monocular-Inertial/EuRoC.yaml" --weights "$WEIGHTS" \
      --out "$OUT/${SHORT}_vi.txt" --gt "$GT" "${DEV[@]}" | tee "$OUT/${SHORT}_vi.log"
done
grep -h "ATE RMSE" "$OUT"/*.log
