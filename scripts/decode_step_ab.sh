#!/bin/bash
# One decode step's host time (scripts/decode_step_time.py) of a parent
# checkout and of this one, one process a turn, p c c p repeated three
# times.
#
#   mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
#   bash scripts/decode_step_ab.sh
#
# Run from the repository root on a CUDA card.
ROOT=$(pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for t in p c c p p c c p p c c p; do
  if [ $t = p ]; then cd $ROOT/build/parent; else cd $ROOT; fi
  PYTHONPATH=$(pwd) python $ROOT/scripts/decode_step_time.py $t 2>&1 | tail -1
  cd $ROOT
done
