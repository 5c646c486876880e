#!/usr/bin/env bash
# One-command parity acceptance run with the PyTorch port. See
# scripts/torch_acceptance.py for the full flag surface (--device among
# them).
#   scripts/torch_acceptance.sh <scene> <data_root> <gt_root> <envmap_dir> \
#       [extra torch_acceptance.py flags...]
set -e
scene="$1"; data_root="$2"; gt_root="$3"; envs="$4"; shift 4
exec python "$(dirname "$0")/torch_acceptance.py" "$scene" \
  --data-root "$data_root" --gt-root "$gt_root" \
  --test-envmap-dir "$envs" --output-root "${OUTPUT_ROOT:-./output}" "$@"
