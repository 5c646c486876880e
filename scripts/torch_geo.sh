#!/usr/bin/env bash
# Stage-1 geometry with the PyTorch port: train, then extract the buffers.
#   scripts/torch_geo.sh <scene> <data_root> [output_root]
# Runs on the CUDA device (the port exits when there is none).
set -e
scene="$1"
data_root="$2"
output_root="${3:-./output}"
python -m vqnerf_release_torch.cli geo-train "$scene" \
  --data-root "$data_root" --output-root "$output_root"
python -m vqnerf_release_torch.cli gen-geo "$scene" \
  --data-root "$data_root" --output-root "$output_root"
