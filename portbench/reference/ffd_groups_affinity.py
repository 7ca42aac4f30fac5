"""The plain reference of the ``ffd_groups_affinity`` estimate: first-fit
decreasing over every node group (``reference/ffd_groups.py``'s rules)
with a node gated by inter-pod affinity and anti-affinity terms, written
from the rules in plain PyTorch, one boolean a term.

A term's domain is the node (a hostname term) or the whole group (a zone
term: a group's nodes share one zone). For a pod of the group's stream,
with ``matches``, ``wants`` (affinity) and ``avoids`` (anti-affinity)
term sets, a node passes when, for every term t:

- t in ``wants``: the group's template carries t's topology label and t's
  domain holds a pod matching t, or no placed pod in the group matches t
  yet and the pod matches t itself (the first pod of a self-affine app);
- t in ``avoids``: t's domain holds no pod matching t (where labelled);
- t in ``matches``: t's domain holds no pod that avoids t (where
  labelled: anti-affinity is symmetric).

A node not open yet has an empty hostname domain: there a wanted hostname
term needs the first-pod case, and only zone terms see the group's pods.
It imports nothing of the program.
"""
from __future__ import annotations

import torch

from portbench.reference.ffd_groups import Answer, answer, inputs


def solve(world, device, dtype=torch.float32) -> Answer:
    req, allocs, stream, active, order, caps = inputs(world, device, dtype)
    G, P, R = stream.shape
    M = world.max_nodes
    dev = stream.device
    t = {k: torch.tensor(v, device=dev) for k, v in world.terms.items()}
    matches = t["match"].T[order]                                   # [G, P, T]
    wants = t["aff_of"].T[order]
    avoids = t["anti_of"].T[order]
    host = t["node_level"]                                          # [T]
    label = t["has_label"]                                          # [G, T]
    T = host.shape[0]
    host3, label3 = host[None, :, None], label[:, :, None]

    free = allocs[:, None, :].repeat(1, M, 1)                       # [G, M, R]
    opened = torch.zeros(G, dtype=torch.long, device=dev)
    node_of = torch.full((G, P), -1, dtype=torch.long, device=dev)
    on_node = torch.zeros((G, T, M), dtype=torch.bool, device=dev)  # a placed pod matches t
    avoid_node = torch.zeros_like(on_node)                          # a placed pod avoids t
    in_group = torch.zeros((G, T), dtype=torch.bool, device=dev)
    avoid_group = torch.zeros_like(in_group)
    nodes = torch.arange(M, device=dev)
    groups = torch.arange(G, device=dev)
    nothing = torch.zeros((), dtype=dtype, device=dev)
    for s in range(P):
        r = stream[:, s]                                            # [G, R]
        m, a, x = matches[:, s], wants[:, s], avoids[:, s]          # [G, T]
        fits = (r[:, None, :] <= free).all(dim=2)                   # [G, M]
        first_pod = m & ~in_group
        held = torch.where(host3, on_node, in_group[:, :, None])    # [G, T, M]
        held_avoid = torch.where(host3, avoid_node, avoid_group[:, :, None])
        bad = (
            (a[:, :, None] & ~(label3 & (held | first_pod[:, :, None])))
            | (x[:, :, None] & held & label3)
            | (m[:, :, None] & held_avoid & label3)
        )
        bad_new = (
            (a & ~((host & first_pod) | (~host & label & (in_group | first_pod))))
            | (x & ~host & in_group & label)
            | (m & ~host & avoid_group & label)
        )
        gate = torch.where(nodes < opened[:, None], ~bad.any(dim=1), ~bad_new.any(dim=1)[:, None])
        first = torch.where(fits & gate, nodes, M).amin(dim=1)
        place = first < caps
        node = first.clamp(max=M - 1)
        free[groups, node] -= torch.where(place[:, None], r, nothing)
        m_in, x_in = m & place[:, None], x & place[:, None]
        on_node[groups, :, node] |= m_in
        avoid_node[groups, :, node] |= x_in
        in_group |= m_in
        avoid_group |= x_in
        opened = torch.maximum(opened, torch.where(place, first + 1, 0))
        node_of[:, s] = torch.where(place, first, -1)
    return answer(node_of, active, order, req)
