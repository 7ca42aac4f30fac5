"""Journal state codec: bit-exact array serialization and row-scatter
deltas.

The wire shape reuses the arena's ``DeltaProgram`` vocabulary (snapshot/
arena.py): one op per dirty field, axis-0 row indices plus payload rows.
The journal's diff is computed HERE, byte-level, against the recorder's
shadow copy — not trusted from the packer's dirty-row sets — so a row the
packer happened to rewrite with identical bytes journals as unchanged and
a row it missed can never journal wrong: reconstruction is bit-exact by
construction.

Bit-exact means byte-exact: rows are compared on their raw bytes, never
with ``!=`` on the values, so ``-0.0`` vs ``0.0`` and NaN payload bits
survive a journal round-trip (f32 capacity columns make this load-bearing,
not theoretical).

The port's copy of ``autoscaler_tpu/journal/codec.py``.
"""
from __future__ import annotations

import base64
import hashlib
from typing import Any, Dict, List, Optional

import numpy as np


def sha256_hex(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def encode_array(arr: np.ndarray) -> Dict[str, Any]:
    """{dtype, shape, b64}: dtype.str keeps the byte order explicit, the
    payload is the C-order buffer — decode is a reshape, no parsing."""
    a = np.ascontiguousarray(arr)
    return {
        "dtype": a.dtype.str,
        # np.ascontiguousarray promotes 0-d to 1-d; journal the source
        # shape so scalars decode back 0-d (the buffer is identical)
        "shape": list(np.shape(arr)),
        "b64": base64.b64encode(a.tobytes(order="C")).decode("ascii"),
    }


def decode_array(doc: Dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(doc["b64"])
    arr = np.frombuffer(raw, dtype=np.dtype(doc["dtype"]))
    return arr.reshape(tuple(doc["shape"])).copy()


def _row_view(arr: np.ndarray) -> np.ndarray:
    """[rows, row_bytes] uint8 view of an array's C-order buffer."""
    a = np.ascontiguousarray(arr)
    rows = a.shape[0]
    width = a.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    return np.frombuffer(a.tobytes(order="C"), dtype=np.uint8).reshape(
        rows, width
    )


def changed_rows(prev: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """Axis-0 indices whose raw bytes differ (shapes/dtypes must match —
    a shape or dtype change is a keyframe, not a delta)."""
    if prev.shape != cur.shape or prev.dtype != cur.dtype:
        raise ValueError(
            f"delta across shape/dtype change: {prev.dtype}{prev.shape} vs "
            f"{cur.dtype}{cur.shape}"
        )
    if cur.ndim == 0 or cur.size == 0:
        return np.zeros((0,), dtype=np.int64)
    diff = _row_view(prev) != _row_view(cur)
    return np.nonzero(diff.any(axis=1))[0]


def delta_ops(
    prev: Dict[str, np.ndarray], cur: Dict[str, np.ndarray]
) -> List[Dict[str, Any]]:
    """Row-scatter ops turning ``prev`` into ``cur`` (DeltaProgram shape:
    field name, axis 0, index list, payload rows). Field names iterate
    sorted so two identical states emit byte-identical op lists. Scalars
    (0-d) ship as full replacements with axis -1."""
    ops: List[Dict[str, Any]] = []
    for name in sorted(cur):
        p, c = prev[name], cur[name]
        if c.ndim == 0:
            if np.ascontiguousarray(p).tobytes() != np.ascontiguousarray(
                c
            ).tobytes():
                ops.append({"field": name, "axis": -1,
                            "payload": encode_array(c)})
            continue
        idx = changed_rows(p, c)
        if idx.size:
            ops.append({
                "field": name,
                "axis": 0,
                "idx": [int(i) for i in idx],
                "payload": encode_array(c[idx]),
            })
    return ops


def apply_ops(
    fields: Dict[str, np.ndarray], ops: List[Dict[str, Any]]
) -> None:
    """Scatter ``ops`` into ``fields`` in place (reader-side replay of one
    delta record). Raises KeyError/ValueError on drifted ops — the reader
    wraps those into its typed SchemaDriftError rather than reconstructing
    wrong."""
    for op in ops:
        name = op["field"]
        if name not in fields:
            raise KeyError(name)
        payload = decode_array(op["payload"])
        if op.get("axis", 0) == -1:
            if payload.shape != fields[name].shape:
                raise ValueError(
                    f"{name}: replacement shape {payload.shape} != "
                    f"{fields[name].shape}"
                )
            fields[name] = payload
            continue
        idx = np.asarray(op["idx"], dtype=np.int64)
        target = fields[name]
        if idx.size and (idx.min() < 0 or idx.max() >= target.shape[0]):
            raise ValueError(f"{name}: scatter index out of bounds")
        if payload.shape[1:] != target.shape[1:]:
            raise ValueError(
                f"{name}: payload rows {payload.shape} do not fit "
                f"{target.shape}"
            )
        target[idx] = payload


def names_delta(
    prev: List[Optional[str]], cur: List[Optional[str]]
) -> Dict[str, Any]:
    """Patch list for one name table: new length plus [index, name] pairs
    where the entry changed (rows swap-fill on removal, so tables shrink
    and grow without ever renumbering surviving rows)."""
    patches = [
        [i, name]
        for i, name in enumerate(cur)
        if i >= len(prev) or prev[i] != name
    ]
    return {"len": len(cur), "set": patches}


def apply_names_delta(
    prev: List[Optional[str]], delta: Dict[str, Any]
) -> List[Optional[str]]:
    out: List[Optional[str]] = list(prev[: int(delta["len"])])
    out.extend([None] * (int(delta["len"]) - len(out)))
    for i, name in delta["set"]:
        if not 0 <= int(i) < len(out):
            raise ValueError(f"name patch index {i} outside table")
        out[int(i)] = name
    return out
