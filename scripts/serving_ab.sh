#!/bin/bash
# GPT-2 small and TinyLlama-1.1B serving (chip_smoke.py's serving_phase and
# llama_serving_phase) of a parent checkout and of this one, one process a
# turn, in the order given (default p c c p p c c p p c); then each side's
# runs and medians of tokens/s, per-token p50 and TTFT p50.
#
#   mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
#   bash scripts/serving_ab.sh ["p c c p"]
#
# Run from the repository root on a CUDA card; logs go to $OUT_DIR
# (default build/serving_ab).
ROOT=$(pwd)
OUT=${OUT_DIR:-$ROOT/build/serving_ab}
ORDER=${1:-p c c p p c c p p c}
mkdir -p $OUT
rm -f $OUT/ab2_*.log
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for t in $ORDER; do
  i=$((i+1))
  if [ $t = p ]; then cd $ROOT/build/parent; else cd $ROOT; fi
  python -c "
import chip_smoke as cs
from apex_tpu_torch import _kernels
smi = cs.device_phase(); _kernels.build_all()
cs.serving_phase(smi)
cs.llama_serving_phase(smi)
" > $OUT/ab2_${i}_$t.log 2>&1
  echo "$i $t rc=$?"
  cd $ROOT
done
OUT=$OUT python - <<'PY'
import glob, json, os, statistics
rows = {"p": {}, "c": {}}
logs = glob.glob(os.path.join(os.environ["OUT"], "ab2_*.log"))
for f in sorted(logs, key=lambda f: int(os.path.basename(f).split("_")[1])):
    side = f.rsplit("_", 1)[1][0]
    for line in open(f):
        for name in ("serving", "llama serving"):
            if line.startswith(name + " {"):
                r = json.loads(line[len(name) + 1:])
                for k in ("tokens_per_s", "per_token_p50_ms", "ttft_p50_ms"):
                    rows[side].setdefault((name, k), []).append(r[k])
for key in rows["p"]:
    p, c = rows["p"][key], rows["c"][key]
    print(key, "parent", [round(x, 1) for x in p], "median", round(statistics.median(p), 1),
          "| change", [round(x, 1) for x in c], "median", round(statistics.median(c), 1))
PY
