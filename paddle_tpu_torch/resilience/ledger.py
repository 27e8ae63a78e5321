"""Black-box flight recorder. Counterpart of
``paddle_tpu/resilience/ledger.py``, copied as is (it imports no JAX).

An append-only JSONL ledger of events (serving: anomalies, rebuilds,
replays, sheds, drains; the fleet: routes, migrations, kills). Bounded:
the in-memory view is a ring of the last ``max_records`` events, and the
on-disk file is compacted back down to that ring whenever it grows past
twice the bound, so a supervisor left running for weeks cannot fill the
disk.

Live ledgers register in a module-wide weakref list, so
``global_counters()`` sums their event counts without holding any
supervisor alive; the profiler's ``resilience:`` line and the
observability registry's ``resilience`` collector read it.
"""
from __future__ import annotations

import collections
import json
import os
import time
import weakref

__all__ = ["FlightLedger", "global_counters"]


class FlightLedger:
    """Bounded append-only event recorder.

    ``record(event, **fields)`` stamps wall-clock time and appends one
    JSON object per line; ``path=None`` keeps the ledger memory-only.
    ``scope`` names the subsystem whose counters it feeds ("serving" for
    ``EngineSupervisor``, "fleet" for ``ReplicaFleet``, "train" for the
    training supervisor).
    """

    def __init__(self, path=None, max_records: int = 2048,
                 scope: str = "train"):
        self.path = os.path.abspath(path) if path else None
        self.max_records = int(max_records)
        self.scope = str(scope)
        self._ring = collections.deque(maxlen=self.max_records)
        self._file_lines = 0
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            if os.path.exists(self.path):
                for rec in self.read(self.path):
                    self._ring.append(rec)
                    self._file_lines += 1
        _register(self)

    def record(self, event: str, **fields):
        rec = {"t": round(time.time(), 6), "event": str(event), **fields}
        self._ring.append(rec)
        if self.path:
            line = json.dumps(rec, default=str)
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")
            self._file_lines += 1
            if self._file_lines > 2 * self.max_records:
                self._compact()
        return rec

    def _compact(self):
        """Rewrite the file down to the in-memory ring (atomically: the
        tmp file is renamed over the ledger so a kill mid-compaction
        never loses the tail)."""
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in self._ring:
                fh.write(json.dumps(rec, default=str) + "\n")
        os.replace(tmp, self.path)
        self._file_lines = len(self._ring)

    # -- queries -----------------------------------------------------------

    def tail(self, n: int = 20):
        """The last ``n`` records, oldest first."""
        return list(self._ring)[-n:]

    def to_list(self):
        return list(self._ring)

    def counts(self):
        """{event: count} over the retained window."""
        return dict(collections.Counter(r["event"] for r in self._ring))

    def __len__(self):
        return len(self._ring)

    @staticmethod
    def read(path):
        """Parse a ledger file -> list of records. Tolerates a torn final
        line (the process may have been killed mid-append)."""
        out = []
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    break        # torn tail from a kill mid-write
        return out


_LEDGERS = []   # weakrefs; dead ledgers drop out of the global snapshot


def _register(ledger):
    _LEDGERS.append(weakref.ref(ledger))


def global_counters(scope=None):
    """Event counts summed across every live ledger; ``scope`` keeps the
    ledgers of one subsystem only (None sums everything)."""
    total = {"ledgers": 0}
    live = []
    for ref in _LEDGERS:
        led = ref()
        if led is None:
            continue
        live.append(ref)
        if scope is not None and led.scope != scope:
            continue
        total["ledgers"] += 1
        for event, n in led.counts().items():
            total[event] = total.get(event, 0) + n
    _LEDGERS[:] = live
    return total
