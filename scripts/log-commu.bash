#!/bin/bash
# tee capture of a HW-in-the-loop session — parity with the reference's
# scripts/log-comuu.bash (console stream + timestamped log file).
set -euo pipefail
EXAMPLE="${1:-mpc-ukf-commu}"
shift || true
mkdir -p "logs/${EXAMPLE}"
python -m mpc_rs_jax.apps.run "${EXAMPLE}" --console "$@" \
  | tee "logs/${EXAMPLE}/${EXAMPLE}-$(date +%Y%m%d%H%M%S).log"
