"""The one generator: a configuration and a traffic mix, with a seed, give
a pool of distinct worlds, each one scale-up estimate in the sidecar's
packed form (numpy on the host, as a caller holds it).

The numbers are drawn on the run's device by a ``torch.Generator`` in a
few large calls, then copied to the host once: the same seed gives the
same worlds on the same device and PyTorch. World ``i`` of a pool draws
from its own seed, derived from the run's seed and ``i``. Every seed gives
the same sizes; only the values move.

Ranges in a configuration are half-open, ``[lo, hi)``, as numpy's
``Generator.integers`` reads them; a list of values is a uniform choice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

MIB_PER_MB = 10**6 / 2**20


@dataclass
class World:
    name: str
    pod_req: np.ndarray            # [P, R] f32
    masks: np.ndarray              # [G, P] bool
    allocs: np.ndarray             # [G, R] f32
    caps: np.ndarray               # [G] i32
    max_nodes: int
    terms: Optional[dict] = None   # match, aff_of, anti_of [T, P]; node_level [T]; has_label [G, T]

    @property
    def pod_groups(self) -> int:
        return self.masks.shape[0] * self.masks.shape[1]

    def operand_bytes(self) -> int:
        arrays = [self.pod_req, self.masks, self.allocs, self.caps]
        if self.terms is not None:
            arrays += list(self.terms.values())
        return sum(a.nbytes for a in arrays)

    def answer_bytes(self) -> int:
        """node counts [G] i32 and each pod's verdict in each group [G, P]."""
        G, P = self.masks.shape
        return G * 4 + G * P


def world_seed(seed: int, i: int) -> int:
    """World i's own seed: any whole number (negative ones too) goes in."""
    state = np.random.SeedSequence([seed % 2**64, i]).generate_state(2, np.uint32)
    return int(state[0]) << 32 | int(state[1])


def build_pool(config: dict, traffic: dict, seed: int, device) -> List[World]:
    return [
        build_world(config, traffic, world_seed(seed, i), device, f"w{i}")
        for i in range(traffic["pool"])
    ]


def _pod_memory(config, traffic, P, integers) -> torch.Tensor:
    """Each pod's memory in MiB: whole MiB (``Mi``), or whole decimal
    megabytes over the same range (``M``: k·10⁶/2²⁰ MiB, mostly not whole)."""
    lo, hi = config["pod_memory_mib"]
    unit = traffic["memory_unit"]
    if unit == "Mi":
        return integers(lo, hi, P).to(torch.float64)
    if unit == "M":
        k = integers(math.ceil(lo / MIB_PER_MB), math.ceil(hi / MIB_PER_MB), P)
        return k.to(torch.float64) * 10**6 / 2**20
    raise ValueError(f"memory_unit must be 'Mi' or 'M', got {unit!r}")


def build_world(config: dict, traffic: dict, seed: int, device, name: str) -> World:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    P, G = config["pods"], config["groups"]
    axis = {r: i for i, r in enumerate(config["resources"])}

    def integers(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def choice(values, n):
        return torch.tensor(values, device=dev)[integers(0, len(values), n)]

    req = torch.zeros((P, len(axis)), dtype=torch.float64, device=dev)
    req[:, axis["cpu"]] = integers(*config["pod_cpu_m"], P).to(torch.float64)
    req[:, axis["memory"]] = _pod_memory(config, traffic, P, integers)
    gpu_pods = uniform(P) < config["gpu_pod_share"]
    req[:, axis["gpu"]] = torch.where(gpu_pods, integers(*config["pod_gpus"], P), 0).to(torch.float64)
    req[:, axis["pods"]] = 1

    allocs = torch.zeros((G, len(axis)), dtype=torch.float64, device=dev)
    allocs[:, axis["cpu"]] = choice(config["group_cpu_m"], G).to(torch.float64)
    allocs[:, axis["memory"]] = choice(config["group_memory_mib"], G).to(torch.float64)
    gpu_groups = uniform(G) < config["gpu_group_share"]
    allocs[:, axis["gpu"]] = torch.where(gpu_groups, config["group_gpus"], 0).to(torch.float64)
    allocs[:, axis["pods"]] = config["pods_per_node"]

    # the masks stand for the non-resource predicates (taints, selectors);
    # GPU pods fit GPU groups only
    masks = uniform(G, P) > config["masked_share"]
    masks &= ~(~gpu_groups[:, None] & gpu_pods[None, :])

    terms = None
    if config["terms"]:
        terms = _terms(config, P, G, integers, uniform, dev)
    return World(
        name=name,
        pod_req=req.to(torch.float32).cpu().numpy(),
        masks=masks.cpu().numpy(),
        allocs=allocs.to(torch.float32).cpu().numpy(),
        caps=np.full(G, config["max_nodes"], np.int32),
        max_nodes=config["max_nodes"],
        terms=None if terms is None else {k: v.cpu().numpy() for k, v in terms.items()},
    )


def _terms(config, P, G, integers, uniform, dev) -> dict:
    """Inter-pod (anti-)affinity: a share of the pods holds one term each,
    that of its app; a term is hostname anti-affinity, zone affinity or zone
    anti-affinity by the configuration's mix; every template carries both
    topology labels."""
    T = config["terms"]
    mix = config["term_mix"]
    involved = uniform(P) < config["term_pod_share"]
    app = integers(0, T, P)
    kind = uniform(T)
    node_level = kind < mix["hostname_anti"]
    is_aff = (kind >= mix["hostname_anti"]) & (kind < mix["hostname_anti"] + mix["zone_affinity"])
    match = involved[None, :] & (app[None, :] == torch.arange(T, device=dev)[:, None])
    return {
        "match": match,
        "aff_of": match & is_aff[:, None],
        "anti_of": match & ~is_aff[:, None],
        "node_level": node_level,
        "has_label": torch.ones((G, T), dtype=torch.bool, device=dev),
    }
