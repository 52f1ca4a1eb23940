#!/bin/sh
# Greedy against sampled serving within one machine: six fresh launcher
# processes of the full-width qwen3-14b <- qwen2.5-3b pair on one card, at
# temperatures 0, 1, 1, 0, 0, 1 (interleaved, so host drift hits both).
# Prints one line per run: index, temperature, rounds, wall s, wall ms per
# round, tokens/s, acceptance; then the card's name and power limit.
# Usage, from the repository root:  sh tools/ab_temperature.sh [out_dir]
set -e
out=${1:-build/ab_temperature}
mkdir -p "$out"
i=0
for t in 0 1.0 1.0 0 0 1.0; do
  i=$((i + 1))
  f="$out/ab_${i}_t${t}.json"
  PYTHONPATH=src python -m repro_torch.launch.serve --target qwen3-14b \
    --draft qwen2.5-3b --full-size --max-batch 4 --requests 8 --max-new 32 \
    --gamma-max 8 --seed 0 --policy static --gamma 4 --temperature "$t" \
    --json > "$f"
  python3 -c "import json; s = json.load(open('$f')); print($i, s['temperature'], s['iterations'], round(s['wall_s'], 3), round(s['wall_s'] / s['iterations'] * 1e3, 1), round(s['tokens_per_s'], 3), round(s['mean_acceptance'], 4))"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
