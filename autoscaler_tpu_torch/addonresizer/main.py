"""Addon-resizer process: poll node count, resize one deployment's container.

Reference: addon-resizer/nanny/main.go (flags: --cpu/--extra-cpu/--memory/
--extra-memory per node, --deployment/--container/--namespace, --poll-period,
--threshold) and nanny_lib.go:103 (PollAPIServer) / :125 (updateResources).
The reference writes requests=limits on the target container; so does this.

The port's copy of ``autoscaler_tpu/addonresizer/main.py``.
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional

from autoscaler_tpu_torch.addonresizer.nanny import LinearEstimator, Nanny
from autoscaler_tpu_torch.kube.client import ApiError, KubeRestClient
from autoscaler_tpu_torch.kube.convert import (
    format_cpu_millis,
    format_memory_quantity,
    parse_cpu_millis,
    parse_quantity,
    resources_from_map,
)
from autoscaler_tpu_torch.kube.objects import Resources
from autoscaler_tpu_torch.utils.poll import poll_loop

log = logging.getLogger("nanny")


class NannyRunner:
    """One poll: count nodes, read the target container, resize on drift."""

    def __init__(
        self,
        client: KubeRestClient,
        namespace: str,
        deployment: str,
        container: str,
        estimator: LinearEstimator,
    ):
        self.client = client
        self.namespace = namespace
        self.deployment = deployment
        self.container = container
        self.nanny = Nanny(estimator, self._apply)
        # the deployment object fetched by the current poll; _apply mutates
        # and PUTs it back whole (read-modify-write — a JSON merge-patch
        # would REPLACE the containers array per RFC 7386, stripping
        # image/env from the container and failing apiserver validation)
        self._dep: Optional[dict] = None
        self._target: Optional[dict] = None

    def _dep_path(self) -> str:
        return (
            f"/apis/apps/v1/namespaces/{self.namespace}"
            f"/deployments/{self.deployment}"
        )

    def _apply(self, new: Resources) -> None:
        qty = {
            "cpu": format_cpu_millis(new.cpu_m),
            "memory": format_memory_quantity(new.memory),
        }
        # nanny writes requests == limits
        self._target["resources"] = {"requests": dict(qty), "limits": dict(qty)}
        # PUT carries the GET's resourceVersion: a concurrent writer makes
        # this 409 and the next poll retries from fresh state
        self.client.put(self._dep_path(), self._dep)

    def run_once(self) -> bool:
        """→ True when the deployment was resized (nanny_lib.go:103)."""
        nodes = self.client.get("/api/v1/nodes").get("items") or []
        self._dep = self.client.get(self._dep_path())
        containers = (
            ((self._dep.get("spec") or {}).get("template") or {}).get("spec")
            or {}
        ).get("containers") or []
        self._target = next(
            (c for c in containers if c.get("name") == self.container), None
        )
        if self._target is None:
            raise ApiError(
                0, f"container {self.container!r} not in {self.deployment}"
            )
        resources = self._target.get("resources") or {}
        current = resources_from_map(resources.get("requests"))
        if self.nanny.poll(current, len(nodes)):
            return True
        # requests are in-band, but the reference's checkResource compares
        # limits too (nanny_lib.go:125 enforces requests == limits): a
        # drifted or missing limit is reconciled even when requests hold
        limits = resources_from_map(resources.get("limits"))
        if (limits.cpu_m, limits.memory) != (current.cpu_m, current.memory):
            self._apply(self.nanny.estimator.estimate(len(nodes)))
            return True
        return False


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tpu-autoscaler-nanny")
    p.add_argument("--kube-api", required=True)
    p.add_argument("--namespace", default="kube-system")
    p.add_argument("--deployment", required=True)
    p.add_argument("--container", default="")
    p.add_argument("--cpu", default="300m", help="base cpu")
    p.add_argument("--extra-cpu", default="2m", help="cpu per node")
    p.add_argument("--memory", default="200Mi", help="base memory")
    p.add_argument("--extra-memory", default="1Mi", help="memory per node")
    p.add_argument("--threshold", type=float, default=10.0,
                   help="deadband percent before resizing")
    p.add_argument("--poll-period", type=float, default=10.0)
    p.add_argument("--max-iterations", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.kube_api == "in-cluster":
        client = KubeRestClient.in_cluster(user_agent="tpu-autoscaler-nanny")
    else:
        client = KubeRestClient(args.kube_api, user_agent="tpu-autoscaler-nanny")
    runner = NannyRunner(
        client,
        args.namespace,
        args.deployment,
        args.container or args.deployment,
        LinearEstimator(
            base_cpu_m=parse_cpu_millis(args.cpu),
            cpu_per_node_m=parse_cpu_millis(args.extra_cpu),
            base_memory=parse_quantity(args.memory),
            memory_per_node=parse_quantity(args.extra_memory),
            deadband_fraction=args.threshold / 100.0,
        ),
    )
    print(f"tpu-autoscaler-nanny: {args.namespace}/{args.deployment} "
          f"container {runner.container}, every {args.poll_period}s")

    def tick():
        if runner.run_once():
            log.info("resized %s", args.deployment)

    return poll_loop(tick, args.poll_period, args.max_iterations, logger=log)


if __name__ == "__main__":
    sys.exit(main())
