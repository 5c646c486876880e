#!/usr/bin/env bash
# The four test passes with the PyTorch port:
#   scripts/torch_test.sh <scene> <data_root> <test_envmap_dir> [output_root]
set -e
scene="$1"
data_root="$2"
envs="$3"
output_root="${4:-./output}"
python -m vqnerf_release_torch.cli test "$scene" \
  --data-root "$data_root" --output-root "$output_root" \
  --test-envmap-dir "$envs"
