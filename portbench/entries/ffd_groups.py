"""The system under test where a configuration's estimate is
``ffd_groups``: the calls the estimator's cuda rung makes for a plain
per-pod estimate (``estimator/binpacking.py``, ``_estimate_many_plain``),
on the sidecar's packed numpy operands. The glue inside the entry picks K2
(``ffd_scan_swar``) where every request and capacity is a whole number, K1
(``ffd_scan_f32``) otherwise."""
from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity

LIBRARIES = ("ffd_scan",)
# the program's launch counters of the scan kernels
COUNTERS = (ffd_scan.LAUNCHES, ffd_scan_affinity.LAUNCHES)


def upload(world, device):
    return ffd_scan.operands_from_numpy(
        world.pod_req, world.masks, world.allocs, world.caps, device=device
    )


def estimate(operands, world):
    req, masks, allocs, caps = operands
    return ffd_scan.ffd_binpack_groups_cuda(req, masks, allocs, world.max_nodes, caps)


def fetch(result):
    """→ (node counts [G] i32, scheduled [G, P] bool) on the host."""
    return result.node_count.cpu().numpy(), result.scheduled.cpu().numpy()
