"""Logical-axis sharding rules (MaxText-style) for the production mesh.

The counterpart of ``repro/parallel/sharding.py``.  Model code names the
*logical* axes of every parameter, cache and optimizer leaf (the ``*_axes``
functions of `models` and `optim.adamw`); the active rule set maps them to
mesh axes.  Changing distribution strategy (FSDP on/off, TP degree,
sequence parallelism, expert placement) is a rules edit, not a model edit,
which is what makes the §Perf hillclimbs (`launch.hillclimb`) cheap to
express.

Mesh axes: ("pod", "data", "model") multi-pod, ("data", "model") single pod.

What differs from the reference:

  * a spec is the port's own `PartitionSpec` (``P``), a tuple of entries,
    each a mesh axis name, a tuple of names, or None.  A one-name tuple
    stays a tuple: under a (1, 1) ("data", "model") mesh ``logical("batch",
    "mlp") == (("data",), "model")``, where jax's ``PartitionSpec`` folds
    the tuple to ``"data"``;
  * the mesh in scope is this module's (`set_mesh` / `get_abstract_mesh`,
    the counterparts of ``jax_compat``'s), an abstract `launch.mesh.Mesh`;
  * `shard` returns its input as it is, with a mesh in scope or without:
    one card places nothing.  The specs serve the dry-run stand-in
    (`launch.dryrun`), which sizes every leaf per device from them.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

MESH_AXES = ("pod", "data", "model")

# logical axis -> mesh axis (or tuple, or None)
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,            # "model" under sequence parallelism
    "embed": "data",        # FSDP: weight d_model dim sharded over data
    "embed_act": None,      # activation d_model dim (None; "model" under SP)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,     # d_ff inside experts when experts aren't sharded
    "vocab": "model",
    "state": None,          # SSM / RG-LRU recurrent state dim
    "stage": None,          # layer-stack dim under scan
    "kv_batch": ("pod", "data"),  # KV-cache batch dim
    "kv_seq": None,
}


class PartitionSpec(tuple):
    """A tuple of per-dimension entries: a mesh axis name, a tuple of
    names, or None (replicated).  Missing trailing entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingRules:
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))

    def spec(self, *logical: str | None) -> P:
        return P(*(self.rules.get(ax) if ax is not None else None
                   for ax in logical))

    def with_overrides(self, **kw) -> "ShardingRules":
        new = dict(self.rules)
        new.update(kw)
        return ShardingRules(new)


_state = threading.local()


def current_rules() -> ShardingRules:
    return getattr(_state, "rules", None) or ShardingRules()


@contextmanager
def use_rules(rules: ShardingRules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


@contextmanager
def set_mesh(mesh):
    """Put ``mesh`` in scope for `logical` and `shard` (thread-local,
    restored on exit)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def get_abstract_mesh():
    """The mesh currently in scope, or None outside any `set_mesh`."""
    return getattr(_state, "mesh", None)


def logical(*axes: str | None) -> P:
    """PartitionSpec for logical axes under the active rules, pruned to the
    axes that exist in the current mesh (so single-pod meshes accept
    ('pod','data') batch rules transparently)."""
    spec = current_rules().spec(*axes)
    mesh = get_abstract_mesh()
    if mesh is None:
        return spec
    names = set(mesh.axis_names)

    def prune(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*(prune(e) for e in spec))


def shard(x, *axes: str | None):
    """The reference's ``with_sharding_constraint`` under the active
    logical rules: ``x`` itself, since one card places nothing."""
    return x


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= mesh.shape[a]
        return n
    return mesh.shape[entry]


def prune_spec_for_shape(spec: P, shape, mesh) -> P:
    """Drop spec entries that do not evenly divide the corresponding dim, and
    de-duplicate mesh axes (first positional use wins — e.g. under sequence
    parallelism `seq` and `heads` both map to 'model'; the earlier dim keeps
    the sharding)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used: set = set()
    out = []
    for dim, entry in zip(shape, entries):
        names = (entry if isinstance(entry, (tuple, list))
                 else [entry]) if entry is not None else []
        if any(a in used for a in names) or dim % _axis_size(mesh, entry) != 0:
            out.append(None)
            continue
        used.update(names)
        out.append(entry)
    return P(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def tree_map(fn, tree, *rest, is_leaf):
    """``fn`` over the leaves of ``tree`` (dicts, lists and named tuples of
    leaves), with the matching nodes of ``rest`` alongside."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    subs = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
            for i, v in enumerate(tree)]
    if isinstance(tree, list):
        return subs
    return type(tree)(*subs) if hasattr(tree, "_fields") else type(tree)(subs)


def prune_tree_specs(spec_tree, abstract_tree, mesh):
    """prune_spec_for_shape over matching trees (params / opt state /
    caches); the abstract tree's leaves have a ``.shape`` (tensors on the
    ``meta`` device)."""
    return tree_map(lambda s, a: prune_spec_for_shape(s, a.shape, mesh),
                    spec_tree, abstract_tree,
                    is_leaf=lambda x: isinstance(x, P))


def param_specs(tree_axes):
    """Map a tree of logical-axis tuples to PartitionSpecs."""
    return tree_map(lambda axes: logical(*axes), tree_axes, is_leaf=_is_axes)
