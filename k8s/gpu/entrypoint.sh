#!/usr/bin/env bash
# Rank bootstrap of the PyTorch port for IndexedJob pods on GPU nodes.
#
# k8s/entrypoint.sh does the work, unchanged: JOB_COMPLETION_INDEX and
# NUM_PROCESSES become JAX_PROCESS_ID / JAX_NUM_PROCESSES, the index-0
# pod's IP becomes JAX_COORDINATOR_ADDRESS, SIGTERM is forwarded and the
# exit code mapped onto the taxonomy. The port reads those names first
# (llmtrain_tpu_torch/distributed resolve_topology: the rank, the world
# size and the tcp:// rendezvous of its process group, one card a pod,
# LOCAL_RANK 0). The `python` of k8s/gpu/bin runs the port where the
# script runs `python -m llmtrain_tpu`.
set -euo pipefail
here="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PATH="${here}/bin:${PATH}"
exec bash "$(dirname "${here}")/entrypoint.sh"
