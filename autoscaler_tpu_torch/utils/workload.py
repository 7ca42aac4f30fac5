"""The repo's headline scale-up workload, generated from a seed: the port's
own copy of ``build_workload`` in ``bench.py`` (which imports the JAX
package). 100k pending heterogeneous pods (cpu/mem, 10% with GPUs) × 500
node groups, 6 resource axes, a cap of 1000 nodes a group; the masks
stand for the non-resource predicate outcomes (taints/selectors), and GPU
pods fit only GPU groups."""
from __future__ import annotations

import numpy as np

from autoscaler_tpu_torch.kube.objects import CPU, GPU, MEMORY, NUM_RESOURCES, PODS

HEADLINE_PODS = 100_000
HEADLINE_GROUPS = 500
HEADLINE_MAX_NODES = 1000


def build_workload(P=HEADLINE_PODS, G=HEADLINE_GROUPS, seed=0):
    """→ (pod_req [P, 6] f32, masks [G, P] bool, allocs [G, 6] f32,
    caps [G] i32), memory in MiB, identical to bench.build_workload."""
    rng = np.random.default_rng(seed)
    pod_req = np.zeros((P, NUM_RESOURCES), np.float32)
    pod_req[:, CPU] = rng.integers(50, 2000, P)
    pod_req[:, MEMORY] = rng.integers(64, 8192, P)
    gpu_pods = rng.random(P) < 0.1
    pod_req[gpu_pods, GPU] = rng.integers(1, 4, int(gpu_pods.sum()))
    pod_req[:, PODS] = 1

    allocs = np.zeros((G, NUM_RESOURCES), np.float32)
    allocs[:, CPU] = rng.choice([4000, 8000, 16000, 32000], G)
    allocs[:, MEMORY] = rng.choice([8192, 16384, 32768, 65536], G)
    gpu_groups = rng.random(G) < 0.2
    allocs[gpu_groups, GPU] = 8
    allocs[:, PODS] = 110

    masks = rng.random((G, P)) > 0.05
    masks[np.ix_(~gpu_groups, gpu_pods)] = False
    caps = np.full(G, HEADLINE_MAX_NODES, np.int32)
    return pod_req, masks, allocs, caps
