"""Shape buckets: the compile-cost contract of the fleet service.

Production fleet traffic means arbitrary (P, G, R) request shapes, and
every distinct shape is a distinct XLA compile (ROADMAP item 5). The fleet
service therefore admits requests into a SMALL closed set of power-of-two
shape buckets: each request is exact-padded up to the smallest configured
bucket that fits it, so the steady-state compile-cache key set is bounded
by ``len(buckets)`` and ladder-rung pre-warm can touch every key at
startup — the first real request never compiles.

Exact-pad safety (the GL007 contract argument, restated for the fleet
operand set): a padded POD row carries ``mask=False`` in every group (the
scan's ``active`` gate — it can never place); a padded GROUP carries
``alloc=0`` and ``cap=0`` (``can_open = opened < 0`` is false, so it opens
nothing and schedules nothing); a padded RESOURCE column carries ``req=0``
against ``alloc=0`` (``0 <= 0`` fits — the column gates nothing, including
``ffd_scores``, which reads only the CPU/MEMORY axes). The scenario axis
pads with all-zero worlds. Demux is therefore a pure slice: the first
(P, G) block of scenario ``s`` IS tenant ``s``'s solo answer, byte for
byte — the property tests/test_fleet.py locks on randomized worlds.

Stdlib + numpy only; jax stays on the dispatch side (fleet/coalescer.py →
parallel/mesh.py).

The port's copy of ``autoscaler_tpu/fleet/buckets.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

# the default bucket ladder: small interactive requests and a medium tier;
# deploy sites size their own via --fleet-shape-buckets
DEFAULT_BUCKETS = "64x8x8,256x16x16"

# the resident-arena prewarm ladder (snapshot/arena.py), same PxGxR grammar
# read as (pods, nodes, resources-cap); lives HERE so config/options.py can
# import the default without pulling jax (ONE source, like DEFAULT_BUCKETS).
# Deploy sites size their own via --arena-buckets.
DEFAULT_ARENA_BUCKETS = "64x16x8,1024x256x8"


class BucketError(ValueError):
    """A bucket spec string that doesn't describe a usable ladder."""


@dataclass(frozen=True, order=True)
class BucketSpec:
    """One (P, G, R) shape bucket. Ordering is lexicographic on (P, G, R),
    which makes "smallest fitting bucket" a min() over the fitting set.
    The static scan carry is ``max_nodes = P``: a node only opens when a
    pod is placed on it, so a tenant can never need more carry rows than
    it has pods — its own node budget rides the dynamic caps row."""

    pods: int
    groups: int
    resources: int

    def fits(self, P: int, G: int, R: int) -> bool:
        return P <= self.pods and G <= self.groups and R <= self.resources

    def cells(self) -> int:
        """Mask cells per scenario slot — the padding-waste denominator."""
        return self.pods * self.groups

    @property
    def key(self) -> str:
        return f"{self.pods}x{self.groups}x{self.resources}"


def pow2ceil(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def parse_buckets(spec: str) -> List[BucketSpec]:
    """``"64x8x8,256x16x16"`` → sorted BucketSpecs. Dimensions must be
    positive powers of two (the exact-pad rules and mesh divisibility both
    lean on it); duplicates collapse."""
    out = set()
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        dims = part.split("x")
        if len(dims) != 3:
            raise BucketError(
                f"bucket {part!r} must be PxGxR (e.g. 64x8x8)"
            )
        try:
            p, g, r = (int(d) for d in dims)
        except ValueError:
            raise BucketError(f"bucket {part!r} has non-integer dims") from None
        for name, v in (("P", p), ("G", g), ("R", r)):
            if v <= 0 or v != pow2ceil(v):
                raise BucketError(
                    f"bucket {part!r}: {name}={v} must be a positive power "
                    "of two (exact-pad + mesh divisibility)"
                )
        out.add(BucketSpec(p, g, r))
    if not out:
        raise BucketError(f"no buckets in spec {spec!r}")
    return sorted(out)


def format_buckets(buckets: Sequence[BucketSpec]) -> str:
    return ",".join(b.key for b in sorted(buckets))


def select_bucket(
    buckets: Sequence[BucketSpec], P: int, G: int, R: int
) -> Optional[BucketSpec]:
    """Smallest configured bucket admitting a (P, G, R) request; None when
    the request exceeds every bucket (the coalescer then mints an ad-hoc
    pow2 bucket — served correctly, just never pre-warmed)."""
    fitting = [b for b in buckets if b.fits(P, G, R)]
    return min(fitting) if fitting else None


def adhoc_bucket(P: int, G: int, R: int) -> BucketSpec:
    """The exact-pow2 envelope of an over-sized request."""
    return BucketSpec(pow2ceil(P), pow2ceil(G), pow2ceil(R))


def pad_operands(
    bucket: BucketSpec,
    pod_req: np.ndarray,     # [P, R] f32
    pod_masks: np.ndarray,   # [G, P] bool
    allocs: np.ndarray,      # [G, R] f32
    caps: np.ndarray,        # [G] i32
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One tenant's exact operands → the bucket shape, zero-padded per the
    exact-pad rules above. Caller has already clamped ``caps`` with the
    tenant's own max_nodes (that clamp is what keeps bucket-carry padding
    answer-preserving)."""
    P, R = pod_req.shape
    G = pod_masks.shape[0]
    if not bucket.fits(P, G, R):
        raise BucketError(
            f"request (P={P}, G={G}, R={R}) exceeds bucket {bucket.key}"
        )
    req = np.zeros((bucket.pods, bucket.resources), np.float32)
    req[:P, :R] = pod_req
    masks = np.zeros((bucket.groups, bucket.pods), bool)
    masks[:G, :P] = pod_masks
    al = np.zeros((bucket.groups, bucket.resources), np.float32)
    al[:G, :R] = allocs
    cp = np.zeros((bucket.groups,), np.int32)
    cp[:G] = caps
    return req, masks, al, cp


def padding_waste(
    bucket: BucketSpec, shapes: Sequence[Tuple[int, int, int]], batch_slots: int
) -> float:
    """Fraction of the batch's (S × P × G) mask cells that are padding —
    the fleet's efficiency tax, reported per batch (metrics + scorer).
    ``shapes`` are the real (P, G, R) triples of the coalesced requests;
    empty scenario slots count fully."""
    total = float(batch_slots * bucket.cells())
    if total <= 0:
        return 0.0
    real = sum(min(p, bucket.pods) * min(g, bucket.groups) for p, g, _ in shapes)
    return max(0.0, 1.0 - real / total)
