"""Elastic training: membership, re-rank, and checkpoint-resume.
Counterpart of ``paddle_tpu/distributed/elastic.py``, copied as is (it
imports no JAX). The launcher-driven relaunch (``distributed/launch``)
is not in the port yet (ROADMAP.md, port queue item 7).

Reference: python/paddle/distributed/fleet/elastic/manager.py:1 (etcd-backed
ElasticManager: node registration under a job scope, a watch loop that
detects joined/lost nodes, re-ranked PADDLE_TRAINER_ID assignment, and
restart-with-scale-in/out). No etcd here: membership is a directory of
heartbeat files on a shared filesystem (a multi-node GPU cluster
mounts one), which gives the same register/watch/re-rank contract with
plain POSIX semantics.

Training scripts use :func:`maybe_resume` so a re-formed gang continues
from the last durable checkpoint instead of step 0.
"""
from __future__ import annotations

import os
import time
from typing import Optional

__all__ = ["ElasticMembership", "maybe_resume", "attempt_number"]


class ElasticMembership:
    """File-heartbeat membership for one training job.

    Each node registers under ``run_dir`` and refreshes its heartbeat;
    nodes whose heartbeat goes stale past ``timeout`` are lost (the
    reference's etcd lease expiry). ``rerank()`` maps the sorted live
    node ids onto contiguous trainer ranks — the re-rank the reference
    manager pushes through etcd watch callbacks.
    """

    def __init__(self, run_dir, node_id, timeout=30.0):
        self.run_dir = os.path.abspath(run_dir)
        self.node_id = str(node_id)
        self.timeout = float(timeout)
        os.makedirs(self.run_dir, exist_ok=True)

    def _path(self, node_id):
        return os.path.join(self.run_dir, f"node.{node_id}")

    def register(self):
        self.heartbeat()
        return self

    def heartbeat(self):
        # a heartbeat is disposable: a torn write reads as a stale stamp
        # and self-heals on the next beat; an extra rename per beat
        # would just add metadata churn
        with open(self._path(self.node_id), "w") as fh:
            fh.write(str(time.time()))

    def leave(self):
        try:
            os.remove(self._path(self.node_id))
        except FileNotFoundError:
            pass

    def peers(self, include_self=True):
        """Live node ids (heartbeat within timeout), sorted."""
        now = time.time()
        out = []
        for name in os.listdir(self.run_dir):
            if not name.startswith("node."):
                continue
            nid = name[len("node."):]
            if not include_self and nid == self.node_id:
                continue
            path = os.path.join(self.run_dir, name)
            try:
                with open(path) as fh:
                    stamp = float(fh.read().strip() or 0)
            except (OSError, ValueError):
                continue
            # cross-process liveness: heartbeat files carry wall-clock
            # stamps (monotonic clocks aren't comparable across
            # processes), so wall minus wall is the right arithmetic
            if now - stamp <= self.timeout:
                out.append(nid)
        return sorted(out)

    def lost(self, known):
        """Subset of ``known`` node ids no longer alive."""
        alive = set(self.peers())
        return sorted(set(map(str, known)) - alive)

    def rerank(self):
        """(new_rank, new_world_size) for this node over the live set;
        rank is None if this node itself is not (or no longer) live."""
        alive = self.peers()
        world = len(alive)
        try:
            return alive.index(self.node_id), world
        except ValueError:
            return None, world

    def wait_for(self, n, timeout=60.0, poll=0.5):
        """Block until n nodes are live (gang formation barrier)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self.peers()) >= n:
                return True
            time.sleep(poll)
        return False


def attempt_number() -> int:
    """Which elastic relaunch this process belongs to (0 = first)."""
    return int(os.environ.get("PADDLE_ELASTIC_ATTEMPT", "0"))


def maybe_resume(manager, template=None) -> tuple[int, Optional[object]]:
    """Resume point for an elastic training script.

    Returns (next_step, state): the newest durable checkpoint restored
    through ``manager`` (a distributed.checkpoint.CheckpointManager) —
    resharded onto the current mesh via ``template`` — or (0, None) when
    the job starts fresh. Safe to call unconditionally at script start;
    a re-formed gang finds the pre-failure checkpoint this way.
    """
    try:
        step, state = manager.restore_latest(template)
    except FileNotFoundError:
        return 0, None
    return step + 1, state
