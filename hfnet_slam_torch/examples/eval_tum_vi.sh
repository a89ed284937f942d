#!/usr/bin/env bash
# Evaluate TUM-VI room sequences, monocular and mono-inertial (the
# reference's Examples/eval_tum_vi.sh loop) with the port's runners.
#   $1 = dataset root containing dataset-room1_512_16/ ... room6
#   $2 = HF-Net weights .npz
#   $3 = a checkout of the upstream HFNet-SLAM project (its
#        Examples/Monocular{,-Inertial}/TUM-VI.yaml settings)
#   ground truths: $1/<seq>/mav0/mocap0/data_tum.txt (mocap converted to TUM)
# Run from the repository root; DEVICE=cpu runs on the CPU (default: CUDA).
set -euo pipefail
ROOT=${1:?dataset root}
WEIGHTS=${2:?weights .npz}
UPSTREAM=${3:?upstream HFNet-SLAM checkout}
OUT=${OUT:-tumvi_eval}
DEV=()
[ -n "${DEVICE:-}" ] && DEV=(--device "$DEVICE")
mkdir -p "$OUT"

for N in 1 2 3 4 5 6; do
  SEQ="dataset-room${N}_512_16"
  GT="$ROOT/$SEQ/mav0/mocap0/data_tum.txt"
  GTARG=()
  [ -f "$GT" ] && GTARG=(--gt "$GT")
  echo "=== $SEQ (mono) ==="
  python3 -m hfnet_slam_torch.examples.run_tum_vi "$ROOT/$SEQ/mav0" \
      --config "$UPSTREAM/Examples/Monocular/TUM-VI.yaml" --weights "$WEIGHTS" \
      --out "$OUT/room${N}_mono.txt" "${GTARG[@]}" "${DEV[@]}" | tee "$OUT/room${N}_mono.log"
  echo "=== $SEQ (mono-inertial) ==="
  python3 -m hfnet_slam_torch.examples.run_tum_vi "$ROOT/$SEQ/mav0" --imu \
      --config "$UPSTREAM/Examples/Monocular-Inertial/TUM-VI.yaml" --weights "$WEIGHTS" \
      --out "$OUT/room${N}_vi.txt" "${GTARG[@]}" "${DEV[@]}" | tee "$OUT/room${N}_vi.log"
done
grep -h "ATE RMSE" "$OUT"/*.log || true
