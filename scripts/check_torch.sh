#!/usr/bin/env bash
# The port's CPU gate: every part of scripts/check.sh that has a port
# counterpart, run on the plain PyTorch versions with --device cpu.
#   bash scripts/check_torch.sh           # port tests (-m "not slow") + smokes
#   bash scripts/check_torch.sh --full    # port tests, slow markers included
# The benchmarks.bench_* smokes of check.sh have no port counterpart yet:
# they wait for the port's benchmark.  The docs check covers the reference.
set -euo pipefail
cd "$(dirname "$0")/.."

PYTEST_MARK=(-m "not slow")
if [[ "${1:-}" == "--full" ]]; then
    PYTEST_MARK=()
fi

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
SERVE=(python -m repro_torch.launch.serve --arch llama3.2-1b --smoke
       --device cpu)
SCRATCH="$(mktemp -d)"
trap 'rm -rf "$SCRATCH"' EXIT

echo "== static analysis (saralint contract checks, fail on any finding) =="
python -m repro_torch.analysis src/repro_torch

echo "== port tests =="
python -m pytest -x -q "${PYTEST_MARK[@]}" tests/test_torch_*.py

echo "== serving smoke =="
"${SERVE[@]}"

echo "== sanitizer smoke (poison/generation/leak traps stay silent) =="
"${SERVE[@]}" --sanitize --kv-layout paged

echo "== trace smoke (serve --trace-out -> schema + category validation) =="
"${SERVE[@]}" --trace-out "$SCRATCH/trace.json"
python scripts/check_trace_torch.py "$SCRATCH/trace.json"

echo "== prefix-cache smoke (COW page sharing == cache-off greedy) =="
"${SERVE[@]}" --prefix-cache --trace-out "$SCRATCH/prefix.json"
python scripts/check_trace_torch.py --require-event cache_hit \
    "$SCRATCH/prefix.json"

echo "== spec-decode smoke (speculative == plain greedy, drafts accepted) =="
"${SERVE[@]}" --spec-draft self

echo "== chaos smoke (faults injected + contained, survivors greedy-equal) =="
"${SERVE[@]}" --chaos 2 --deadline 40 --trace-out "$SCRATCH/chaos.json"
python scripts/check_trace_torch.py --require-event fault \
    "$SCRATCH/chaos.json"

echo "== self-adaptive smoke (train -> save -> load -> serve adaptnet) =="
python -m repro_torch.launch.train_adaptnet --samples 8000 --epochs 2 \
    --buckets 64 --out "$SCRATCH/adaptnet_ckpt" --quiet --device cpu
"${SERVE[@]}" --dispatcher adaptnet --adaptnet-ckpt "$SCRATCH/adaptnet_ckpt"

echo "== sharded training smoke (4 CPU ranks, torchrun, gloo, (2, 2) dp_all) =="
torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
    --data-axis 2 --model-axis 2 --device cpu --steps 3 --optimized \
    --ckpt "$SCRATCH/sharded_ckpt"

echo "check_torch.sh: all green"
