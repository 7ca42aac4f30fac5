"""TPU-request sanitizer.

Reference: cluster-autoscaler/utils/tpu/tpu.go:57 (ClearTPURequests): the
reference strips `cloud-tpus.google.com/*` resource requests from pods
before simulation, because TPU devices are attached after scheduling and
would otherwise make every pod unschedulable in the simulated world. In this
framework TPU capacity is a first-class resource axis, so the sanitizer is
*configurable*: strip the legacy cloud-tpus requests (parity behavior), keep
native tpu-axis requests.

The port's copy of ``clear_tpu_requests`` from ``autoscaler_tpu/utils/tpu.py``.
``pin_cpu_if_requested`` is JAX's and is not copied: the port's entry points
take a device instead (``main.py --device``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from autoscaler_tpu_torch.kube.objects import Pod

LEGACY_TPU_PREFIX = "cloud-tpus.google.com/"


def clear_tpu_requests(pods: Sequence[Pod], strip_native: bool = False) -> List[Pod]:
    """→ pods with (legacy) TPU requests removed; untouched pods pass through
    by identity so callers can cheaply detect changes."""
    out: List[Pod] = []
    for pod in pods:
        legacy = any(k.startswith(LEGACY_TPU_PREFIX) for k in pod.annotations)
        if (pod.requests.tpu and strip_native) or legacy:
            requests = dataclasses.replace(
                pod.requests, tpu=0.0 if (strip_native or legacy) else pod.requests.tpu
            )
            annotations = {
                k: v
                for k, v in pod.annotations.items()
                if not k.startswith(LEGACY_TPU_PREFIX)
            }
            out.append(
                dataclasses.replace(pod, requests=requests, annotations=annotations)
            )
        else:
            out.append(pod)
    return out
