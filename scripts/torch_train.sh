#!/usr/bin/env bash
# The three decomposition phases with the PyTorch port:
#   scripts/torch_train.sh <scene> <data_root> [output_root]
# Runs all three phases for the scene's dataset family on the CUDA device.
set -e
scene="$1"
data_root="$2"
output_root="${3:-./output}"
python -m vqnerf_release_torch.cli decomp-train "$scene" \
  --data-root "$data_root" --output-root "$output_root" --phase all
