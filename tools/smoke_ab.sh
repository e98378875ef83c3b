#!/bin/bash
# Times chip_smoke.py of several checkouts on one host, in the order given:
#   OUT=<dir> tools/smoke_ab.sh build/parent build/tree
# Each DIR is a `git archive` unpacked into a directory .gitignore lists,
# so each builds its kernels cold in its own build/.  Writes each run's
# output to $OUT/smoke_<name>.log and "<name> rc=.. wall_s=.." to
# $OUT/ab.txt (and stdout), then the end of each log.  OUT defaults to
# build/smoke_ab.
out=${OUT:-build/smoke_ab}
mkdir -p "$out"
out=$(cd "$out" && pwd)
for dir in "$@"; do
  name=$(basename "$dir")
  start=$(date +%s.%N)
  (cd "$dir" && python3 chip_smoke.py > "$out/smoke_$name.log" 2>&1)
  rc=$?
  wall=$(awk -v a="$start" -v b="$(date +%s.%N)" 'BEGIN{printf "%.1f", b - a}')
  echo "$name rc=$rc wall_s=$wall" | tee -a "$out/ab.txt"
  tail -c 3000 "$out/smoke_$name.log"
done
