#!/bin/sh
# Time the kernels (esr_tpu_torch/ops/cuda/conv_bench.py) of two source trees
# on one card in turns A, B, B, A, so that a change is held against its parent
# within one call (calls land on cards that differ):
#
#     tools/conv_ab.sh PARENT_DIR [CHANGE_DIR [CONV_BENCH_ARGS...]]
#
# e.g. ``tools/conv_ab.sh PARENT . --f32`` for the f32 route. Each
# tree builds its own kernels at its first run and runs its own conv_bench
# with the arguments given. Prints the card's name and power limit, then one
# BENCH line a run, labelled a (PARENT_DIR) or b (CHANGE_DIR, default .).
set -e
A=$(cd "$1" && pwd)
B=$(cd "${2:-.}" && pwd)
shift
[ $# -gt 0 ] && shift
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for label in a b b a; do
  if [ "$label" = a ]; then dir=$A; else dir=$B; fi
  printf '%s ' "$label"
  (cd "$dir" && python3 -m esr_tpu_torch.ops.cuda.conv_bench "$@")
done
