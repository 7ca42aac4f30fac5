"""Priority expander: operator-defined group preference tiers.

Reference: cluster-autoscaler/expander/priority/priority.go — a live ConfigMap
maps integer priorities to lists of node-group-name regexes; the expander
keeps only options whose group matches the highest priority tier present.
Three tiers of config source, all hot-swappable without restart:
PriorityFilter holds a plain dict (set_priorities); ConfigMapPriorityFilter
re-reads the live ConfigMap per BestOptions call — the reference's actual
mechanism, wired through ClusterAPI.read_configmap; and
FileWatchingPriorityFilter mtime-watches a file (a projected ConfigMap
volume, or any path a sidecar keeps fresh) for hosts without an API binding.

The port's copy of ``autoscaler_tpu/expander/priority.py``.
"""
from __future__ import annotations

import json
import os
import re
import logging
from typing import Callable, Dict, List, Optional, Sequence

from autoscaler_tpu_torch.expander.core import Filter, Option

logger = logging.getLogger(__name__)


def parse_priorities(text: str) -> Dict[int, List[str]]:
    """Config format: a mapping of priority (int or numeric string, higher
    wins) to a list of node-group-id regexes — parsed as YAML, which also
    accepts JSON. This is the exact payload shape of the reference's
    `priorities` ConfigMap key (expander/priority/priority.go).

    EVERY malformed input raises ValueError (never re.error/TypeError):
    both hot-reload filters catch ValueError to keep serving the last good
    tiers, so no payload shape may crash a scale-up decision."""
    try:
        import yaml

        try:
            raw = yaml.safe_load(text)
        except yaml.YAMLError as e:
            raise ValueError(f"priority config is not valid YAML/JSON: {e}") from None
    except ImportError:
        # PyYAML missing (minimal install): JSON remains fully supported
        try:
            raw = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"priority config is not valid JSON (and PyYAML is not "
                f"installed for YAML payloads): {e}"
            ) from None
    if not isinstance(raw, dict):
        raise ValueError("priority config must be an object of prio -> [regex]")
    out: Dict[int, List[str]] = {}
    for k, v in raw.items():
        if not isinstance(v, (list, tuple)):
            raise ValueError(
                f"priority {k!r}: expected a list of regexes, got {type(v).__name__}"
            )
        patterns = [str(p) for p in v]
        for p in patterns:
            try:
                re.compile(p)  # surface bad regexes at parse time
            except re.error as e:
                raise ValueError(f"priority {k!r}: bad regex {p!r}: {e}") from None
        try:
            prio = int(k)
        except (TypeError, ValueError):
            raise ValueError(f"priority key {k!r} is not an integer") from None
        out[prio] = patterns
    return out


class PriorityFilter(Filter):
    def __init__(self, priorities: Dict[int, Sequence[str]]):
        self._compiled: Dict[int, List[re.Pattern]] = {}
        self.set_priorities(priorities)

    def set_priorities(self, priorities: Dict[int, Sequence[str]]) -> None:
        self._compiled = {
            prio: [re.compile(p) for p in patterns]
            for prio, patterns in priorities.items()
        }

    def _priority_of(self, group_id: str) -> int:
        best = None
        for prio, patterns in self._compiled.items():
            if any(p.search(group_id) for p in patterns):
                if best is None or prio > best:
                    best = prio
        return best if best is not None else -(10**9)

    def best_options(self, options: List[Option]) -> List[Option]:
        if not options:
            return []
        prios = [(self._priority_of(o.node_group.id()), o) for o in options]
        top = max(p for p, _ in prios)
        return [o for p, o in prios if p == top]


class FileWatchingPriorityFilter(PriorityFilter):
    """Hot-reloading priority filter (reference priority/priority.go: the
    expander re-fetches the ConfigMap on every BestOptions call). The config
    file's mtime is checked before each decision; on change the file is
    re-parsed and the tiers swapped in without a restart. A broken edit
    keeps the last good config (the reference logs and keeps serving too)."""

    def __init__(self, path: str, fallback: Optional[Dict[int, Sequence[str]]] = None):
        self.path = path
        self._sig: Optional[tuple] = None
        self.last_error: Optional[str] = None
        super().__init__(fallback or {})
        self.maybe_reload()

    def maybe_reload(self) -> bool:
        """Re-parse the config if the file changed; True if tiers swapped.
        The change signature is (mtime_ns, size) — plain mtime misses
        rewrites landing within the filesystem's timestamp granularity."""
        try:
            st = os.stat(self.path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError as e:
            self.last_error = f"stat {self.path}: {e}"
            return False
        if sig == self._sig:
            return False
        try:
            with open(self.path) as f:
                parsed = parse_priorities(f.read())
        except (OSError, ValueError, json.JSONDecodeError) as e:
            self.last_error = f"parse {self.path}: {e}"
            self._sig = sig  # don't re-parse a bad file every call
            return False
        self.set_priorities(parsed)
        self._sig = sig
        self.last_error = None
        return True

    def best_options(self, options: List[Option]) -> List[Option]:
        self.maybe_reload()
        return super().best_options(options)


# The reference's well-known ConfigMap (priority.go).
PRIORITY_CONFIGMAP_NAME = "cluster-autoscaler-priority-expander"
PRIORITY_CONFIGMAP_KEY = "priorities"


class ConfigMapPriorityFilter(PriorityFilter):
    """Live-ConfigMap priority tiers, the reference's actual mechanism
    (expander/priority/priority.go re-reads the ConfigMap on every
    BestOptions call through an informer-backed lister).

    ``fetch`` returns the ConfigMap's data dict (or None if absent) — a
    bound ClusterAPI.read_configmap in production, any callable in tests.
    The payload under ``key`` is re-parsed only when its text changes.

    Error behavior mirrors priority.go's BestOptions (reload error → return
    every option unfiltered) for a *gone* config source: ConfigMap deleted
    or missing the key disables prioritization rather than pinning
    decisions to tiers read from an object that no longer exists — unless
    the operator passed explicit ``fallback`` tiers, which exist precisely
    for the no-ConfigMap case and stay in force. Divergence kept on
    purpose: a present-but-malformed payload serves the last GOOD tiers (a
    fat-fingered edit shouldn't instantly disable prioritization); the
    reference disables there too. Both states are logged on transition and
    surfaced via ``last_error``."""

    def __init__(
        self,
        fetch: Callable[[], Optional[Dict[str, str]]],
        key: str = PRIORITY_CONFIGMAP_KEY,
        fallback: Optional[Dict[int, Sequence[str]]] = None,
    ):
        self._fetch = fetch
        self._key = key
        self._last_text: Optional[str] = None
        self.last_error: Optional[str] = None
        self._source_gone = False
        self._restored = False  # one-shot: last call saw the source absent
        self._fallback: Dict[int, Sequence[str]] = dict(fallback or {})
        super().__init__(self._fallback)
        self.maybe_reload()

    def maybe_reload(self) -> bool:
        try:
            data = self._fetch()
        except Exception as e:  # noqa: BLE001 — a flaky API read must not
            # fail the scale-up decision; keep the last good tiers
            self.last_error = f"fetch: {e}"
            return False
        if data is None:
            self._note_source_gone("configmap absent")
            return False
        text = data.get(self._key)
        if text is None:
            self._note_source_gone(f"configmap has no {self._key!r} key")
            return False
        if self._restored:
            # one-shot: the gone→present transition forces a re-parse even
            # of text identical to the pre-deletion payload; a *persistently
            # malformed* restoration must NOT re-parse (and re-warn) every
            # call, so this keys off the transition, not off _source_gone
            self._restored = False
            self._last_text = None
        if text == self._last_text:
            return False
        try:
            parsed = parse_priorities(text)
        except ValueError as e:
            self.last_error = str(e)
            logger.warning("priority expander configmap invalid: %s", e)
            self._last_text = text  # don't re-parse a bad payload every call
            # NOTE: _source_gone stays set on a malformed restoration — a
            # recreated-with-a-typo ConfigMap must not resurrect the
            # pre-deletion tiers; passthrough holds until valid config
            return False
        self.set_priorities(parsed)
        self._last_text = text
        self.last_error = None
        if self._source_gone:
            logger.info("priority expander config source restored")
            self._source_gone = False
        return True

    def _note_source_gone(self, why: str) -> None:
        self.last_error = why
        self._restored = True  # next present payload re-parses once
        if not self._source_gone:
            if self._fallback:
                logger.warning(
                    "priority expander config source gone (%s): "
                    "reverting to the operator-provided fallback tiers",
                    why,
                )
                self.set_priorities(self._fallback)
            else:
                logger.warning(
                    "priority expander config source gone (%s): "
                    "prioritization disabled, options pass through unfiltered",
                    why,
                )
            self._source_gone = True

    def best_options(self, options: List[Option]) -> List[Option]:
        self.maybe_reload()
        if self._source_gone and not self._fallback:
            return list(options)
        return super().best_options(options)
