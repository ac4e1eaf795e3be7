"""Round-bound derivation for lowered fabric tables (host-side numpy).

The PyTorch port's copy of the two helpers of ``repro.core.verify`` that
`engine.round_bound` needs.  The rest of the fabric-IR verifier — the typed
findings, `verify_workload`, `assert_valid` and ``check="static"`` — is not
ported yet (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import numpy as np


def join_depth(join_id, join_wait) -> int:
    """Longest fork/join chain through rows — the join nesting depth.

    ``depth(p) = 0`` for a row that waits on no group, else ``1 + max``
    depth of the rows contributing to the group it waits on (0 when the
    group has no contributors).  Computed by vectorized scatter-max passes,
    each extending every chain by one level, so a DAG stabilizes in at most
    N+1 passes; a cyclic group graph is capped at N.
    """
    if join_id is None or join_wait is None:
        return 0
    jid = np.asarray(join_id).astype(np.int64)
    jw = np.asarray(join_wait).astype(np.int64)
    n = jid.shape[0]
    if n == 0 or not np.any(jw >= 0):
        return 0
    contrib = jid >= 0
    cid = np.where(contrib, jid, 0)
    depth = np.zeros(n, np.int64)
    for _ in range(n + 1):
        gd = np.zeros(n, np.int64)
        np.maximum.at(gd, cid[contrib], depth[contrib])
        new = np.where(jw >= 0, 1 + gd[np.clip(jw, 0, n - 1)], 0)
        if np.array_equal(new, depth):
            return int(depth.max())
        depth = new
    return n  # cyclic group graph: cap the bound


def round_bound(n_hops: int, join_id=None, join_wait=None) -> int:
    """Sufficient fixpoint round budget for a lowered workload:

        bound = (join_depth + 1) * (3*H + 8)

    ``3*H + 8`` covers chain-only layouts; each join level re-gates issue
    times after a full sub-schedule resolves, so a join-depth-D lowering
    needs at most D+1 such phases.
    """
    per_level = 3 * int(n_hops) + 8
    return (join_depth(join_id, join_wait) + 1) * per_level
