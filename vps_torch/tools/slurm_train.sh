#!/usr/bin/env bash
# SLURM launcher of the port: the counterpart of the repo's
# tools/slurm_train.sh, with one task a card (the reference's layout, where
# the JAX package had one a TPU host). Each task is one rank of
# python -m vps_torch.tools.train --distributed, which reads SLURM_PROCID,
# SLURM_NTASKS and SLURM_LOCALID; the rendezvous is the job's first host at
# MASTER_PORT (default 29500).
#
# Usage: bash vps_torch/tools/slurm_train.sh PARTITION JOB_NAME CONFIG
#            [N_CARDS] [CARDS_PER_NODE] [train args...]

set -euo pipefail
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
NCARDS=${4:-8}
CARDS_PER_NODE=${5:-8}
shift 5 2>/dev/null || shift $#
PYTHON=${PYTHON:-python3}
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"
export MASTER_PORT=${MASTER_PORT:-29500}

srun -p "${PARTITION}" \
    --job-name="${JOB_NAME}" \
    --gres="gpu:${CARDS_PER_NODE}" \
    --ntasks="${NCARDS}" \
    --ntasks-per-node="${CARDS_PER_NODE}" \
    --kill-on-bad-exit=1 \
    "$PYTHON" -m vps_torch.tools.train "${CONFIG}" --distributed "$@"
