#!/usr/bin/env bash
# Trajectory geometry, then the trajectory rendered, with the PyTorch port:
#   scripts/torch_video.sh <scene> <data_root> [output_root] [mode]
set -e
scene="$1"
data_root="$2"
output_root="${3:-./output}"
mode="${4:-gen_comps}"
python -m vqnerf_release_torch.cli geo-video "$scene" \
  --data-root "$data_root" --output-root "$output_root"
family=$(python -c "from vqnerf_release_torch.config import scene_family; print(scene_family('$scene'))")
python -m vqnerf_release_torch.cli gen-video "$scene" \
  --data-root "$data_root" --output-root "$output_root" \
  --video-root "$output_root/surf/${family}_surf/$scene/video" \
  --mode "$mode"
