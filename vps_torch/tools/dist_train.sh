#!/usr/bin/env bash
# Data-parallel training launcher of the port: the counterpart of the
# repo's tools/dist_train.sh and the reference's (torch.distributed.launch
# over N cards), for python -m vps_torch.tools.train.
#
#   bash vps_torch/tools/dist_train.sh CONFIG [args...]
#     One rank in this process, the rendezvous from the environment
#     (torchrun's RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK, or
#     SLURM's SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID): --distributed.
#
#   NPROC=N bash vps_torch/tools/dist_train.sh CONFIG [args...]
#     N local ranks with an explicit rendezvous at localhost:$PORT (default
#     a random port in 20000-39999), rank i on cuda:i unless the arguments
#     name one card (--device cuda:0 --dist-backend gloo puts every rank on
#     card 0). Each rank gets OMP_NUM_THREADS=1 unless it is set. Exits
#     with the first failing rank's code, after stopping the others; 0 when
#     all succeed.
#
# The arguments after CONFIG go to the train tool. PYTHON names the
# interpreter (default python3).

set -euo pipefail
CONFIG=$1
shift || true

NPROC=${NPROC:-1}
PYTHON=${PYTHON:-python3}
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"

if [ "$NPROC" -le 1 ]; then
    exec "$PYTHON" -m vps_torch.tools.train "$CONFIG" --distributed "$@"
fi

PORT=${PORT:-$((20000 + RANDOM % 20000))}
# one intra-op thread a rank unless the caller says otherwise, as
# torch.distributed.launch and torchrun do: N ranks of one thread per core
# each oversubscribe the cores N times over
export OMP_NUM_THREADS=${OMP_NUM_THREADS:-1}
pids=()
stop() {
    kill "${pids[@]}" 2>/dev/null || true
}
trap 'stop; exit 143' TERM INT
for ((i = 0; i < NPROC; i++)); do
    LOCAL_RANK=$i "$PYTHON" -m vps_torch.tools.train "$CONFIG" \
        --coordinator "localhost:${PORT}" \
        --num_processes "$NPROC" --process_id "$i" "$@" &
    pids+=($!)
done
rc=0
for ((n = 0; n < NPROC; n++)); do
    r=0
    wait -n || r=$?
    if [ "$r" -ne 0 ] && [ "$rc" -eq 0 ]; then
        rc=$r
        stop  # a rank that failed leaves the others waiting in a collective
    fi
done
exit "$rc"
