#!/bin/bash
# parent, change, change, parent (tools/ab_worker.py) on one card, then the
# GPU tests; logs and JSON under OUT (default build/ab).  Unpack the parent
# first:
#   mkdir -p build/parent_tree && git archive PARENT | tar -x -C build/parent_tree
#   [SECTIONS=ball,seamless] bash tools/ab.sh [OUT]
# SECTIONS: the worker's --sections (default every one).
out=${1:-build/ab}
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
for t in parent1 change1 change2 parent2; do
  tree=.; [[ $t == parent* ]] && tree=build/parent_tree
  extra=""; [[ $t == *1 ]] && extra=--hashes
  s=$(date +%s)
  [[ -n $SECTIONS ]] && extra="$extra --sections $SECTIONS"
  python3 tools/ab_worker.py $tree $t $out/ab_$t.json $extra > $out/ab_$t.log 2>&1
  echo "$t rc=$? in $(( $(date +%s) - s )) s"; tail -n 3 $out/ab_$t.log | cut -c1-400
done
python3 tools/ab_summary.py $out
s=$(date +%s)
PYTHONPATH=src timeout 1100 python -m pytest -q -m gpu tests/test_torch_cuda.py -p no:cacheprovider > $out/gpu_tests.log 2>&1
echo "gpu tests rc=$? in $(( $(date +%s) - s )) s"
tail -n 15 $out/gpu_tests.log | cut -c1-300
