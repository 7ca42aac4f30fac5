"""Scenario-robust expander: pick the group that wins across what-if worlds.

The reference evaluates exactly one present-state snapshot per loop; spot
markets and preemptions make that choice fragile. This strategy prices every
expansion option under S perturbed pricing scenarios and picks the modal
winner — the full (scenario × group) FFD and cost evaluation runs over the
device mesh in one ``whatif_best_options`` call (parallel/mesh.py). There
is no reference equivalent; the seam it plugs into is expander.Strategy
(cluster-autoscaler/expander/expander.go:52).

The port of ``autoscaler_tpu/expander/scenario.py``. On a CUDA card each
scenario's FFD is one K1/K2 launch (``ops/ffd_scan.ffd_binpack_groups_cuda``)
when the kernels' carry fits a block's shared memory (``plain_gate``, the
port of the JAX package's backend and VMEM test), else the torch loop. A
kernel fault raises: nothing falls back.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from autoscaler_tpu_torch.expander.core import Option, Strategy
from autoscaler_tpu_torch.kube.objects import NUM_RESOURCES
from autoscaler_tpu_torch.parallel.mesh import make_mesh, whatif_best_options
from autoscaler_tpu_torch.snapshot.packer import extended_schema, resources_row
from autoscaler_tpu_torch.snapshot.tensors import bucket_size


class ScenarioStrategy(Strategy):
    def __init__(
        self,
        base_prices: Dict[str, float],       # group id → on-demand node price
        num_scenarios: int = 8,
        spot_discount: float = 0.7,          # spot price = base × discount
        preemption_prob: float = 0.3,        # chance a group's spot is revoked
        seed: int = 0,
        mesh=None,                           # parallel/mesh.Mesh; None = make_mesh(device)
        max_nodes: int = 128,
        device=None,                         # None = the first CUDA card
    ):
        self.base_prices = base_prices
        self.num_scenarios = num_scenarios
        self.spot_discount = spot_discount
        self.preemption_prob = preemption_prob
        self.seed = seed
        self.mesh = mesh
        self.max_nodes = max_nodes
        self.device = device
        # the last what-if's route ("cuda": K1/K2, or "torch_scan") and
        # its WhatIfResult
        self.last_route = ""
        self.last_whatif = None

    def operands(self, options: List[Option], S: int, g_dim: int):
        """The what-if operands of ``options`` under S pricing scenarios,
        G padded to ``g_dim``: (pod_req [P, R], masks [G_pad, P], allocs
        [S, G_pad, R], prices [S, G_pad], caps [G_pad]) numpy, drawn from
        ``seed`` as the JAX package draws them."""
        G = len(options)
        G_pad = G + (-G) % g_dim
        # shared pod matrix = union of pods across options (each option's
        # mask selects its own schedulable set)
        all_pods: Dict[str, int] = {}
        pods_list = []
        for o in options:
            for p in o.pods:
                if p.key() not in all_pods:
                    all_pods[p.key()] = len(pods_list)
                    pods_list.append(p)
        P = bucket_size(len(pods_list))
        # named extended resources requested by any pending pod are fit
        # dimensions here too
        ext = extended_schema((p.requests for p in pods_list))
        R = NUM_RESOURCES + len(ext)
        pod_req = np.zeros((P, R), np.float32)
        for i, p in enumerate(pods_list):
            pod_req[i] = resources_row(p.requests, 1.0, ext)

        masks = np.zeros((G_pad, P), bool)
        allocs = np.zeros((S, G_pad, R), np.float32)
        prices = np.full((S, G_pad), 1e9, np.float32)  # padded groups: huge price
        caps = np.ones(G_pad, np.int32)
        rng = np.random.default_rng(self.seed)
        for gi, o in enumerate(options):
            for p in o.pods:
                masks[gi, all_pods[p.key()]] = True
            template = o.node_group.template_node_info()
            row = resources_row(
                template.allocatable, template.allocatable.pods, ext
            )
            base = self.base_prices.get(o.node_group.id(), 1.0)
            caps[gi] = max(
                1, min(self.max_nodes, o.node_group.max_size() - o.node_group.target_size())
            )
            for s in range(S):
                allocs[s, gi] = row
                spot_available = rng.random() > self.preemption_prob
                prices[s, gi] = base * (self.spot_discount if spot_available else 1.0)
        return pod_req, masks, allocs, prices, caps

    def best_option(self, options: List[Option]) -> Optional[Option]:
        from autoscaler_tpu_torch.estimator.binpacking import plain_gate
        from autoscaler_tpu_torch.ops import ffd_scan

        if not options:
            return None
        if len(options) == 1:
            return options[0]
        mesh = self.mesh or make_mesh(None if self.device is None else [self.device])
        s_dim = mesh.shape["scenario"]
        g_dim = mesh.shape["group"]
        # pad S, G to mesh divisibility
        S = max(self.num_scenarios, s_dim)
        S += (-S) % s_dim
        G = len(options)
        pod_req, masks, allocs, prices, caps = self.operands(options, S, g_dim)
        home = mesh.devices.flat[0]
        args = [torch.tensor(a, device=home) for a in (pod_req, masks, allocs, prices, caps)]
        kernel = {}
        self.last_route = "torch_scan"
        # the shared memory of the widest carry a launch can take: one
        # plane per resource axis (the kernels' f32 route)
        R = pod_req.shape[1]
        if all(plain_gate(d, R, self.max_nodes) is None for d in mesh.devices.ravel()):
            kernel = dict(binpack_fn=ffd_scan.ffd_binpack_groups_cuda, scenario_loop=True)
            self.last_route = "cuda"
        res = self.last_whatif = whatif_best_options(
            mesh, *args, max_nodes=self.max_nodes, **kernel
        )
        best = res.best_group.cpu().numpy()
        best = best[best < G]  # drop padded winners (shouldn't happen)
        if best.size == 0:
            return options[0]
        modal = int(np.bincount(best, minlength=G).argmax())
        return options[modal]
