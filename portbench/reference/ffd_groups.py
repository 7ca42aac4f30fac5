"""The plain reference of the ``ffd_groups`` estimate: first-fit decreasing
over every node group, written from the rules alone in plain PyTorch
(cluster-autoscaler's ``estimator/binpacking_estimator.go``):

- each group sorts the pods it may take by score, descending, ties in pod
  order; the score is ``cpu · mem_cap + mem · cpu_cap``, the
  division-free order of ``cpu/cpu_cap + mem/mem_cap``, a zero capacity
  dropping its term, each product and the sum rounded on their own;
- a pod takes the first open node, in the order the nodes were opened,
  whose free capacity covers its request on every resource; if none does,
  it opens a new node of the group's template when the group has fewer
  than its cap of nodes and the empty template covers it; else it is left
  out;
- a pod the group's mask excludes is tested nowhere.

Free capacity is kept and subtracted in ``dtype`` (the configuration's
float32; a lower precision makes the control). The answer is each group's
node count and each pod's verdict in each group, and the fit tests the
rules needed (``portbench.roofline``). It imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CPU, MEMORY = 0, 1  # resource axes, as the configurations list them


class Answer(NamedTuple):
    node_count: np.ndarray   # [G] i32
    scheduled: np.ndarray    # [G, P] bool
    fit_tests: int           # node tests × resources some pod requests


def score_order(req: torch.Tensor, allocs: torch.Tensor) -> torch.Tensor:
    """[G, P]: each group's pods by descending score, ties in pod order."""
    cpu_cap, mem_cap = allocs[:, CPU, None], allocs[:, MEMORY, None]
    s_cpu = torch.where(cpu_cap > 0, req[None, :, CPU] * torch.where(mem_cap > 0, mem_cap, 1), 0)
    s_mem = torch.where(mem_cap > 0, req[None, :, MEMORY] * torch.where(cpu_cap > 0, cpu_cap, 1), 0)
    return torch.sort(-(s_cpu + s_mem), dim=1, stable=True).indices


def inputs(world, device, dtype):
    """The world on ``device``: requests and capacities in ``dtype``, each
    group's pods in score order ([G, P, R], excluded pods +inf), their
    masks and order, the caps."""
    dev = torch.device(device)
    req = torch.tensor(world.pod_req, device=dev).to(dtype)
    allocs = torch.tensor(world.allocs, device=dev).to(dtype)
    masks = torch.tensor(world.masks, device=dev)
    caps = torch.tensor(world.caps, device=dev).long().clamp(max=world.max_nodes)
    order = score_order(req, allocs)
    active = torch.gather(masks, 1, order)
    stream = torch.where(active[:, :, None], req[order], float("inf"))
    return req, allocs, stream, active, order, caps


def answer(node_of, active, order, req) -> Answer:
    """Node counts, verdicts back in pod order, and the fit tests: a pod
    that took node n of the ones open before it tested n + 1 nodes, any
    other pod tested every node open before it. ``node_of`` [G, P] is the
    node each pod of the stream took, -1 for none."""
    placed = node_of >= 0
    scheduled = torch.zeros_like(placed).scatter_(1, order, placed)
    opened_after = torch.cummax(node_of + 1, dim=1).values
    before = torch.nn.functional.pad(opened_after[:, :-1], (1, 0))
    tests = torch.where(placed & (node_of < before), node_of + 1, before)
    resources = int((req > 0).any(dim=0).sum())
    return Answer(
        node_count=opened_after[:, -1].to(torch.int32).cpu().numpy(),
        scheduled=scheduled.cpu().numpy(),
        fit_tests=int(torch.where(active, tests, 0).sum()) * resources,
    )


def solve(world, device, dtype=torch.float32) -> Answer:
    req, allocs, stream, active, order, caps = inputs(world, device, dtype)
    G, P, R = stream.shape
    M = world.max_nodes
    dev = stream.device
    # node M of each group takes what no node takes; it is never tested
    free = allocs[:, None, :].repeat(1, M + 1, 1)                   # [G, M + 1, R]
    flat = free.view(G * (M + 1), R)
    base = torch.arange(G, device=dev) * (M + 1)
    taken = -stream
    first = torch.empty((P, G), dtype=torch.long, device=dev)       # step by step
    nodes = torch.arange(M, device=dev)
    for s in range(P):
        fits = (stream[:, s, None, :] <= free[:, :M]).all(dim=2)    # [G, M]
        # closed nodes hold the whole template, so the first closed node
        # stands for a new one
        torch.amin(torch.where(fits, nodes, M), dim=1, out=first[s])
        node = torch.where(first[s] < caps, first[s], M)
        flat.index_add_(0, base + node, taken[:, s])                # x + (-r) is x - r
    first = first.T
    return answer(torch.where(first < caps[:, None], first, -1), active, order, req)
