"""Elastic scaling: mesh selection for whatever devices survive.

The counterpart of ``repro/runtime/elastic.py``, a copy (the port imports
nothing of the JAX package).  `choose_mesh` picks the best (pod, data,
model) factorization for an arbitrary live-device count (largest usable
power-of-two block, TP capped by the arch's shardable width), and
`resize_plan` describes the checkpoint-based transition — with stateless
data (data.pipeline) and sharding-on-restore checkpoints
(checkpoint.restore), a resize is: save -> rebuild mesh -> restore.  The
plans are the reference's, strings included; on one card the port runs
none of them (`launch.mesh`, `parallel.sharding`).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    usable_devices: int
    dropped_devices: int


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def choose_mesh(n_devices: int, *, model_cap: int = 16,
                prefer_pods: int = 1) -> MeshPlan:
    usable = _pow2_floor(n_devices)
    pods = prefer_pods if usable % prefer_pods == 0 and prefer_pods > 1 else 1
    rest = usable // pods
    model = min(model_cap, _pow2_floor(max(int(rest ** 0.5), 1)))
    data = rest // model
    if pods > 1:
        return MeshPlan((pods, data, model), ("pod", "data", "model"),
                        usable, n_devices - usable)
    return MeshPlan((data, model), ("data", "model"),
                    usable, n_devices - usable)


def resize_plan(old: MeshPlan, n_devices_now: int, **kw) -> dict:
    new = choose_mesh(n_devices_now, **kw)
    return {
        "old": old,
        "new": new,
        "action": "none" if new.shape == old.shape else "save_restore",
        "steps": (
            "1. checkpoint.save (atomic)",
            f"2. rebuild mesh {new.shape} over {new.usable_devices} devices",
            "3. checkpoint.restore with new NamedShardings",
            "4. data pipeline continues at saved step (stateless)",
        ),
    }
