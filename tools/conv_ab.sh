#!/bin/sh
# Time the conv kernel's sites (esr_tpu_torch/ops/cuda/conv_bench.py) of two
# source trees on one card in turns A, B, B, A, so that a change is held
# against its parent within one call (calls land on cards that differ):
#
#     tools/conv_ab.sh PARENT_DIR [CHANGE_DIR, default .]
#
# Each tree builds its own kernels at its first run and times the sites its
# own conv_bench lists. Prints the card's name and power limit, then one
# BENCH line a run, labelled a (PARENT_DIR) or b (CHANGE_DIR).
set -e
A=$(cd "$1" && pwd)
B=$(cd "${2:-.}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for label in a b b a; do
  if [ "$label" = a ]; then dir=$A; else dir=$B; fi
  printf '%s ' "$label"
  (cd "$dir" && python3 -m esr_tpu_torch.ops.cuda.conv_bench)
done
