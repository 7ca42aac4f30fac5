"""The estimator-side adapter of a shared fleet coalescer.

The port of ``FleetEstimatorClient`` in ``autoscaler_tpu/gym/env.py``:
pass one to ``BinpackingNodeEstimator(fleet_client=...)`` and every plain
batched estimate of that estimator rides the coalescer's admission queue
(``estimator/binpacking.py``'s fleet lane), so concurrent estimators
coalesce into shared dispatches with identical answers. The rest of
``gym/`` — ``PolicyGymEnv`` over the load generator's scenario driver,
the policy spec and the tuner — is ROADMAP queue 1 item 6.
"""
from __future__ import annotations


class FleetEstimatorClient:
    """The estimator-side adapter of the shared coalescer: turns one plain
    packed estimate dispatch into a FleetRequest ticket and blocks for the
    demuxed answer. Lives here (not in fleet/) because the tenant identity
    and the blocking-rollout semantics are gym concerns."""

    def __init__(self, coalescer, tenant_id: str, timeout_s: float = 60.0):
        self.coalescer = coalescer
        self.tenant_id = tenant_id
        self.timeout_s = float(timeout_s)

    def estimate_groups(self, req, masks, allocs, caps, max_nodes: int):
        """[P,R]/[G,P]/[G,R]/[G] packed operands → (counts [G], scheduled
        [G,P]) numpy, via one coalesced (possibly co-batched) dispatch."""
        from autoscaler_tpu_torch.fleet.coalescer import FleetRequest

        ticket = self.coalescer.submit(FleetRequest(
            tenant_id=self.tenant_id,
            pod_req=req,
            pod_masks=masks,
            template_allocs=allocs,
            node_caps=caps,
            max_nodes=int(max_nodes),
        ))
        answer = ticket.result(timeout=self.timeout_s)
        return answer.node_counts, answer.scheduled
