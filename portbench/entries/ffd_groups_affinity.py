"""The system under test where a configuration's estimate is
``ffd_groups_affinity``: the calls the estimator's cuda rung makes for a
per-pod estimate under inter-pod (anti-)affinity (``estimator/
binpacking.py``, ``_estimate_many_dynamic`` without spread), on the packed
numpy operands and term rows. The scan is K3 (``ffd_scan_aff``)."""
from autoscaler_tpu_torch.ops import ffd_scan, ffd_scan_affinity

LIBRARIES = ("ffd_scan_affinity",)
# the program's launch counters of the scan kernels
COUNTERS = (ffd_scan.LAUNCHES, ffd_scan_affinity.LAUNCHES)


def upload(world, device):
    t = world.terms
    return ffd_scan_affinity.affinity_operands_from_numpy(
        world.pod_req, world.masks, world.allocs, t["match"], t["aff_of"], t["anti_of"],
        t["node_level"], t["has_label"], world.caps, device=device,
    )


def estimate(operands, world):
    return ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(
        **operands, max_nodes=world.max_nodes
    )


def fetch(result):
    """→ (node counts [G] i32, scheduled [G, P] bool) on the host."""
    return result.node_count.cpu().numpy(), result.scheduled.cpu().numpy()
