#!/bin/bash
# Parent, change, change, parent on one card: B1-B4 at head dims 128 and
# 256 (scripts/kernel_ab.py) in a parent tree and in this checkout. Make the
# parent tree first, in a git-ignored directory:
#   mkdir -p build/parent && git archive <parent commit> | tar -x -C build/parent
# Usage: bash scripts/kernel_ab.sh [log directory, default build/ab]
out=${1:-build/ab}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
cp scripts/kernel_ab.py build/parent/kernel_ab.py
cp scripts/kernel_ab.py kernel_ab_change.py
i=0
for side in parent change change parent; do
  i=$((i+1))
  log="$(cd "$out" && pwd)/run$i-$side.log"
  if [ "$side" = parent ]; then
    (cd build/parent && timeout 600 python3 kernel_ab.py) > "$log" 2>&1
  else
    timeout 600 python3 kernel_ab_change.py > "$log" 2>&1
  fi
  echo "run$i $side rc=$?"
  grep "^AB " "$log" | cut -c1-200
done
rm -f kernel_ab_change.py
