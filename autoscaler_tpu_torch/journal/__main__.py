"""Flight-journal CLI: reconstruct | diff | replay over a journal file.

    python -m autoscaler_tpu_torch.journal reconstruct JOURNAL --tick N
    python -m autoscaler_tpu_torch.journal diff JOURNAL A B
    python -m autoscaler_tpu_torch.journal replay JOURNAL --explain-ledger LEDGER [--device cpu]

``reconstruct`` prints the tick's state summary (per-field shape/dtype/
sha256, name-table sizes); ``diff`` prints the semantic state diff between
two ticks; ``replay`` re-executes every journaled tick's decision path and
byte-compares against the recorded explain ledger — exit 1 on any
divergence (hack/verify.sh drives this as the journal gate). ``replay``
re-runs the preemption passes on ``--device`` (default: the first CUDA
card; ``cpu`` runs them on the host).

The port's copy of ``autoscaler_tpu/journal/__main__.py``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from typing import List

from autoscaler_tpu_torch.journal.diff import semantic_diff
from autoscaler_tpu_torch.journal.ledger import stable_json, validate_records
from autoscaler_tpu_torch.journal.reader import JournalError, JournalReader
from autoscaler_tpu_torch.journal.replay import replay_journal


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m autoscaler_tpu_torch.journal",
        description="black-box flight journal forensics",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("reconstruct",
                         help="rebuild one tick's state from the journal")
    rec.add_argument("journal")
    rec.add_argument("--tick", type=int, default=None,
                     help="tick to reconstruct (default: newest)")

    dif = sub.add_parser("diff",
                         help="semantic state diff between two ticks")
    dif.add_argument("journal")
    dif.add_argument("tick_a", type=int)
    dif.add_argument("tick_b", type=int)

    rep = sub.add_parser(
        "replay",
        help="re-execute each journaled tick's decision path and byte-"
             "compare against the recorded explain ledger (exit 1 on "
             "divergence)",
    )
    rep.add_argument("journal")
    rep.add_argument("--explain-ledger", required=True,
                     help="the run's decision ledger JSONL (loadgen "
                          "--explain-ledger)")
    rep.add_argument("--tick", type=int, default=None,
                     help="replay one tick only (default: all)")
    rep.add_argument("--device", default=None,
                     help="device of the replayed preemption passes "
                          "(default: the first CUDA card; cpu for the host)")
    return p


def _reader(path: str) -> JournalReader:
    reader = JournalReader.from_path(path)
    errors = validate_records(reader.records())
    if errors:
        for e in errors:
            print(f"journal invalid: {e}", file=sys.stderr)
        raise SystemExit(1)
    return reader


def _reconstruct(args) -> int:
    reader = _reader(args.journal)
    ticks = reader.ticks()
    if not ticks:
        print("empty journal", file=sys.stderr)
        return 1
    tick = args.tick if args.tick is not None else ticks[-1]
    state = reader.reconstruct(tick)
    doc = {
        "tick": state.tick,
        "options_fp": state.options_fp,
        "explain_sha256": state.explain_sha256,
        "names": {k: sum(1 for n in v if n is not None)
                  for k, v in sorted(state.names.items())},
        "fields": {
            name: {
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            }
            for name, arr in sorted(state.fields.items())
        },
        "ctx": state.ctx,
    }
    print(json.dumps(doc, indent=2, sort_keys=True))
    return 0


def _diff(args) -> int:
    reader = _reader(args.journal)
    diff = semantic_diff(
        reader.reconstruct(args.tick_a), reader.reconstruct(args.tick_b)
    )
    print(json.dumps(diff, indent=2, sort_keys=True))
    return 0


def _replay(args) -> int:
    reader = _reader(args.journal)
    records = []
    lines: List[str] = []
    with open(args.explain_ledger) as f:
        for lineno, raw in enumerate(f, 1):
            if not raw.strip():
                continue
            try:
                records.append(json.loads(raw))
            except json.JSONDecodeError as e:
                print(f"{args.explain_ledger}:{lineno}: not JSON: {e}",
                      file=sys.stderr)
                return 1
            # hash the RAW line bytes: the journal pinned the line as
            # written, not a re-serialization of it
            lines.append(raw if raw.endswith("\n") else raw + "\n")
    results = replay_journal(reader, records, lines, tick=args.tick,
                             device=args.device)
    diverged = 0
    replayed = 0
    for result in results:
        if result["replayed"]:
            replayed += 1
        for finding in result["divergence"]:
            diverged += 1
            print(f"tick {result['tick']}: DIVERGED: {finding}",
                  file=sys.stderr)
    print(stable_json({
        "ticks": len(results),
        "replayed": replayed,
        "diverged": diverged,
    }))
    return 1 if diverged else 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    try:
        if args.cmd == "reconstruct":
            return _reconstruct(args)
        if args.cmd == "diff":
            return _diff(args)
        return _replay(args)
    except JournalError as e:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(str(e), file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
