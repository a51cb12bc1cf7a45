#!/usr/bin/env bash
# Full-hugewiki driver for the PyTorch/CUDA port: one ALS iteration per
# python process.
#
# Each invocation of `python -m cumf_als_tpu_torch.hugewiki_full
# --state-dir` runs exactly one iteration and persists (theta, with X on
# the host x_host in bf16, the history); this loop re-invokes it until
# ITERS are done. A process's host memory is then bounded by one
# iteration's (the data and the plans are memory-mapped from their
# caches, the lazy plans' stream stores too), and a run that stops is
# resumed by starting the loop again. The state directory is the JAX
# package's format: scripts/hugewiki_full.py can resume it, and this
# loop can resume one that script wrote.
#
# Usage: scripts/torch_hugewiki_full_driver.sh [ITERS] [SCALE] [STATE_DIR]
#            [FLAGS...]
# FLAGS go to every invocation (e.g. --x-placement host, --device cpu).
set -u
ITERS="${1:-10}"
SCALE="${2:-1.0}"
STATE="${3:-hugewiki_state}"
shift $(( $# < 3 ? $# : 3 ))
mkdir -p "$STATE"
for i in $(seq 1 "$ITERS"); do
    next=$(python3 -c "import json,sys,os
p='$STATE/state.json'
print(json.load(open(p))['next_iter'] if os.path.exists(p) else 0)")
    if [ "$next" -ge "$ITERS" ]; then
        echo "[driver] all $ITERS iterations done"
        break
    fi
    echo "[driver] starting iteration $next (pass $i)"
    python3 -m cumf_als_tpu_torch.hugewiki_full --scale "$SCALE" \
        --iters "$ITERS" --state-dir "$STATE" "$@" || {
        echo "[driver] iteration $next failed (exit $?)"; exit 1; }
done
cat "$STATE/state.json"
