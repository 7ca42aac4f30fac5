"""Whether skipping node tiles could spare K4 (``csrc/fit_reduce.cu``)
work at the fit bench's operands (``utils/workload.build_fit_workload``,
seed 0): the node classes every 256-node tile holds, the share of
(pod, tile) pairs where a request exceeds the tile's largest free value of
a resource (the pod fits no node there) or is at most its smallest on
every resource (every compare passes), at tiles of 256 and 32 nodes, and
the share of live pairs that pass the class test and that fit.

    python3 -m autoscaler_tpu_torch.tools.fit_tile_census [--device cpu]

Runs on the card unless ``--device cpu`` is given; prints one line. The
counts depend on the data only, not on the device.
"""
from __future__ import annotations

import argparse

import torch

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.ops import fit_reduce


def tile_census(ops, res, tiles=(256, 32)) -> str:
    """Whether skipping node tiles could spare K4 work on ``ops``: the
    node classes every tile holds; the share of (pod, tile) pairs where a
    request exceeds the tile's largest free value of that resource (the
    pod fits no node there), or is at most its smallest on every resource
    (every compare passes); the share of live pairs that pass the class
    test, and that fit (from ``res``, K4's result)."""
    req, free, pod_class, node_class, class_mask, node_valid = ops
    CP, CN = class_mask.shape
    live_pod = (pod_class >= 0) & (pod_class < CP)
    live_node = node_valid & (node_class >= 0) & (node_class < CN)
    req = req[live_pod]
    parts = []
    for tile in tiles:
        pad = -free.shape[0] % tile
        ok = torch.nn.functional.pad(live_node, (0, pad)).view(-1, tile)
        f = torch.nn.functional.pad(free, (0, 0, 0, pad)).view(-1, tile, free.shape[1])
        hi = torch.where(ok[:, :, None], f, -torch.inf).amax(dim=1)
        lo = torch.where(ok[:, :, None], f, torch.inf).amin(dim=1)
        over = under = 0
        for s0 in range(0, req.shape[0], 8192):
            r = req[s0:s0 + 8192, None, :]
            over += int((r > hi[None]).any(dim=2).sum())
            under += int((r <= lo[None]).all(dim=2).sum())
        pairs = req.shape[0] * hi.shape[0]
        if tile == tiles[0]:
            nc = torch.nn.functional.pad(torch.where(live_node, node_class, CN), (0, pad),
                                         value=CN).view(-1, tile).long()
            seen = torch.zeros((nc.shape[0], CN + 1), dtype=torch.bool, device=nc.device)
            seen.scatter_(1, nc, True)
            held = seen[:, :CN].sum(dim=1)
            parts.append(f"{tile}-node tiles hold {int(held.min())}-{int(held.max())} of "
                         f"{CN} node classes")
        parts.append(f"{tile}-node tiles: a request over the tile's maximum on "
                     f"{100 * over / pairs:.4f}% and under its minimum on every resource "
                     f"on {100 * under / pairs:.4f}% of {pairs} (pod, tile) pairs")
    pods_of = torch.bincount(pod_class[live_pod].long(), minlength=CP).double()
    nodes_of = torch.bincount(node_class[live_node].long(), minlength=CN).double()
    passing = float(pods_of @ class_mask.double() @ nodes_of)
    live_pairs = float(pods_of.sum() * nodes_of.sum())
    parts.append(f"the class test passes on {100 * passing / live_pairs:.2f}% of live pairs, "
                 f"{100 * float(res.fit_count.double().sum()) / live_pairs:.2f}% fit")
    return "; ".join(parts)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = parser.parse_args(argv)
    from autoscaler_tpu_torch.utils.workload import build_fit_workload

    dev = resolve_device(args.device)
    ops = tuple(torch.tensor(a, device=dev) for a in build_fit_workload())
    print(f"fit-K4 tile census: {tile_census(ops, fit_reduce.fit_reduce_cuda(*ops))}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
