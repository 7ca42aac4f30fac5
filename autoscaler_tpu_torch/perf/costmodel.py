"""The cost model: shape signatures, operand accounting, and the model
cost of one estimator dispatch.

The cost model answers "what SHOULD this dispatch have cost": the bytes it
must move and the operations it must do, the two figures PERF.md's kernel
bound is built from. Both are pure functions of the call's shapes (and of
the scan plan the call was handed, which its signature carries), so two
replays read identical numbers and no device is asked.

The port of ``autoscaler_tpu/perf/costmodel.py``. ``shape_signature`` and
``operand_bytes`` are the JAX package's (a torch dtype is written as its
numpy name, so both packages sign the same call alike). ``analyze_cost``
is not: the JAX package lowers and compiles the jitted entry and reads
XLA's cost analysis; the port has no compiler to ask and models the routes
instead (see ``analyze_cost``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from autoscaler_tpu_torch.perf.residency import array_bytes

# The peak rate the utilization figure and PERF.md's bound divide by: the
# NVIDIA H100 80GB HBM3's non-tensor f32 rate (data sheet, at its 700 W
# limit), also taken for its int32 operations. Off a CUDA device, a nominal
# CPU figure (a comparability constant, as in the JAX package).
H100_PEAK_OPS_PER_S = 67e12
NOMINAL_CPU_PEAK_OPS_PER_S = 1.0e11

# routes with a model, by the function they compute
_PLAIN_ROUTES = ("cuda", "torch_scan", "torch_single")
_AFFINITY_ROUTES = ("cuda_affinity", "torch_scan", "torch_single")
# 32-bit operations of one SWAR fit test a plane: or, sub, and, compare
_SWAR_OPS_PER_PLANE = 4


def default_peak_flops(device=None) -> float:
    """The peak rate for ``device`` (None: the first CUDA card when there
    is one): the H100's on a CUDA device, the nominal CPU figure off one."""
    if device is None:
        is_cuda = torch.cuda.is_available()
    else:
        is_cuda = torch.device(device).type == "cuda"
    return H100_PEAK_OPS_PER_S if is_cuda else NOMINAL_CPU_PEAK_OPS_PER_S


def _leaves(obj: Any):
    """Flatten nested tuples/lists (the kernels' spread-term tuples) into
    leaf values, preserving order."""
    if isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _leaves(item)
    else:
        yield obj


def _dtype_name(dtype: Any) -> str:
    """numpy's name for a dtype: ``torch.float32`` → ``float32``."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def _leaf_sig(leaf: Any) -> str:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        dims = "x".join(str(int(d)) for d in shape)
        return f"{dims or 'scalar'}:{_dtype_name(dtype)}"
    if leaf is None:
        return "-"
    if isinstance(leaf, (bool, int, float, str)):
        return repr(leaf)
    return type(leaf).__name__


def shape_signature(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> str:
    """Deterministic compact signature of one kernel call: array leaves as
    ``dims:dtype``, statics by repr, kwargs sorted by name. Two calls share
    a signature iff they have the same shapes, dtypes and static args."""
    parts = [_leaf_sig(leaf) for leaf in _leaves(args)]
    for name in sorted(kwargs):
        vals = ",".join(_leaf_sig(leaf) for leaf in _leaves(kwargs[name]))
        parts.append(f"{name}={vals}")
    return ";".join(parts)


def operand_bytes(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> int:
    """Total bytes of array operands in one kernel call (resident or
    uploaded — the operand arena serves resident tensors, and they count
    as the JAX package counts its resident arrays). Delegates to
    ``residency.array_bytes`` — the one byte model every pool shares."""
    return array_bytes(list(args)) + array_bytes(kwargs)


def _named(args: Tuple[Any, ...], kwargs: Dict[str, Any], i: int, *names: str):
    """The call's ``i``-th operand, passed by position or by one of
    ``names``; None when absent."""
    if len(args) > i:
        return args[i]
    return next((kwargs[n] for n in names if n in kwargs), None)


def analyze_cost(
    route: str, args: Tuple[Any, ...], kwargs: Dict[str, Any]
) -> Optional[Dict[str, float]]:
    """The model cost of one dispatch on ``route``, for the routes that
    compute the per-pod FFD: K1/K2 (``cuda``), K3 (``cuda_affinity``) and
    the torch loops that compute the same functions (``torch_scan``, and
    ``torch_single`` for one template). → {"bytes_accessed", "flops"},
    or None for a route without a model (run compression, the host rungs,
    the arena's scatters), as the JAX function answers None for an entry
    without a compiled surface.

    - ``bytes_accessed``: each operand read once (``operand_bytes``) and
      each output written once: node_count [G] i32, scheduled [G, P]
      bool, node_used [G, max_nodes, R] f32.
    - ``flops``: the 32-bit operations of the unpruned search — every pod
      of every group tested against every node slot (G × P × max_nodes fit
      tests) × planes × operations a test: R f32 compares a test on the
      torch loops and K1; the SWAR planes of ``scan_plan`` × 4 on K2; R +
      the term-bitset planes + the spread terms on the affinity routes.
    """
    dynamic = "match" in kwargs
    if route not in (_AFFINITY_ROUTES if dynamic else _PLAIN_ROUTES):
        return None
    req = _named(args, kwargs, 0, "pod_req")
    masks = _named(args, kwargs, 1, "pod_masks", "pod_mask")
    max_nodes = _named(args, kwargs, 3, "max_nodes")
    if req is None or masks is None or max_nodes is None:
        return None
    P, R = (int(d) for d in req.shape)
    G = int(masks.shape[0]) if len(masks.shape) == 2 else 1
    M = int(max_nodes)
    out_bytes = G * 4 + G * P + G * M * R * 4
    ops_per_test = R
    plan = kwargs.get("scan_plan")
    if dynamic:
        T = int(kwargs["match"].shape[0])
        spread = kwargs.get("spread")
        S = int(spread[0].shape[1]) if spread else 0
        ops_per_test = R + max((T + 31) // 32, 1) + S
    elif plan is not None:
        ops_per_test = (
            len(plan.keep) if plan.plan is None else plan.planes * _SWAR_OPS_PER_PLANE
        )
    return {
        "bytes_accessed": float(operand_bytes(args, kwargs) + out_bytes),
        "flops": float(G * P * M * ops_per_test),
    }
