"""PyTorch port, the production-mesh layer against the JAX reference on the
CPU: the sharding rules (`parallel.sharding`), the logical axes of every
parameter, cache and optimizer leaf (the ``*_axes`` functions of `models`,
`transformer.param_axes` / `cache_axes`, `optim.adamw.state_axes`) and the
meshes (`launch.mesh`).

Every comparison is exact.  The reference's ``PartitionSpec`` folds a
one-name tuple (``("data",)``) to the name on jax 0.9, the port's keeps
the tuple, so specs are compared after folding (`fold`).  A port leaf lines
up with the reference's through `models.convert` (`named_to_tree`,
`cache_to_tree`): a stage-stacked reference leaf carries a leading
``"stage"`` axis, replicated, that the port's per-layer leaf has not.  The
reference's specs are pruned under a ``jax.sharding.AbstractMesh`` of the
production shapes, the port's under its own `launch.mesh.Mesh`.
"""

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from _hyp_compat import given, settings, st  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import convert as CV  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def fold(spec):
    """A spec as a tuple, one-name tuples folded to the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

PRUNE_CASES = [  # tests/test_sharding_rules.py::test_prune_spec_divisibility
    (("model", "data"), (51865, 4096)),
    ((("pod", "data"), None), (1, 10)),
    ((("pod", "data"), None), (256, 10)),
]


@pytest.mark.parametrize("spec, shape", PRUNE_CASES)
def test_prune_spec_cases_equal_reference(spec, shape):
    mesh = FakeMesh({"data": 16, "model": 16, "pod": 2})
    got = S.prune_spec_for_shape(S.P(*spec), shape, mesh)
    assert isinstance(got, S.P)
    assert fold(got) == fold(JS.prune_spec_for_shape(JP(*spec), shape, mesh))


FAKE_MESHES = ({"data": 16, "model": 16, "pod": 2}, {"data": 4, "model": 2},
               {"pod": 3, "data": 1, "model": 8})
DIMS = (1, 2, 3, 4, 6, 8, 10, 16, 32, 48, 96, 256, 51865)


@settings(max_examples=150, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_prune_spec_drawn_equal_reference(seed):
    rng = np.random.default_rng(seed)
    axes = FAKE_MESHES[int(rng.integers(len(FAKE_MESHES)))]
    mesh = FakeMesh(axes)
    names = list(axes) + ["absent"]

    def entry():
        k = int(rng.integers(4))
        if k == 0:
            return None
        if k == 1:
            return str(rng.choice(names[:-1]))
        return tuple(str(a) for a in rng.choice(names[:-1], size=k - 1,
                                                replace=False))

    ndim = int(rng.integers(0, 5))
    shape = tuple(int(rng.choice(DIMS)) for _ in range(ndim))
    spec = tuple(entry() for _ in range(int(rng.integers(0, ndim + 1))))
    got = S.prune_spec_for_shape(S.P(*spec), shape, mesh)
    want = JS.prune_spec_for_shape(JP(*spec), shape, mesh)
    assert fold(got) == fold(want), (spec, shape, axes)


def test_logical_keeps_a_one_name_tuple():
    """tests/test_jax_compat.py:49's rule: under a (1, 1) ("data", "model")
    mesh the ("pod", "data") batch rule prunes to ("data",), kept as a
    tuple (the reference's PartitionSpec folds it on jax 0.9)."""
    assert S.get_abstract_mesh() is None
    assert S.logical("batch", "mlp") == (("pod", "data"), "model")
    with S.set_mesh(M.make_mesh((1, 1), ("data", "model"))):
        spec = S.logical("batch", "mlp")
        assert tuple(spec) == (("data",), "model")
    with jax.sharding.use_abstract_mesh(AbstractMesh((1, 1),
                                                     ("data", "model"))):
        assert fold(spec) == fold(JS.logical("batch", "mlp"))
    assert S.get_abstract_mesh() is None


def test_shard_returns_its_input():
    x = torch.ones(4, 8)
    assert S.shard(x, "batch", None) is x
    with S.set_mesh(M.make_production_mesh()):
        assert S.shard(x, "batch", "mlp") is x


def test_rules_nest_restore_and_equal_reference():
    assert S.MESH_AXES == JS.MESH_AXES
    assert S.DEFAULT_RULES == JS.DEFAULT_RULES
    sp = S.ShardingRules().with_overrides(seq="model")
    assert sp.rules == JS.ShardingRules().with_overrides(seq="model").rules
    assert S.ShardingRules().rules["seq"] is None
    assert fold(sp.spec("batch", "seq", None)) == fold(
        JS.ShardingRules().with_overrides(seq="model").spec(
            "batch", "seq", None))
    ep = S.ShardingRules().with_overrides(experts=None)
    assert S.current_rules().rules == S.DEFAULT_RULES
    with S.use_rules(sp):
        assert S.current_rules() is sp
        with S.use_rules(ep):
            assert S.current_rules() is ep
        assert S.current_rules() is sp
    assert S.current_rules().rules == S.DEFAULT_RULES
    outer, inner = M.make_production_mesh(), M.make_production_mesh(
        multi_pod=True)
    with S.set_mesh(outer):
        with S.set_mesh(inner):
            assert S.get_abstract_mesh() is inner
        assert S.get_abstract_mesh() is outer
    assert S.get_abstract_mesh() is None


def test_meshes():
    single, multi = M.make_production_mesh(), M.make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert single.axis_names == ("data", "model") and single.devices is None
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    host = M.make_host_mesh(model=4, device="cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            M.make_host_mesh()
    with pytest.raises(ValueError):
        M.make_mesh((2, 2), ("a", "b"), devices=["cpu"])


# ---------------------------------------------------------------------------
# the axes of every leaf
# ---------------------------------------------------------------------------

def line_up(leaves, to_tree):
    """(port key, reference path, stacked) for every port leaf: ``leaves``
    maps each key to its place in the port's tree (a function that puts a
    value there), and ``to_tree`` lays the port's tree of index tensors out
    as the reference's."""
    keys = list(leaves)
    tree = to_tree({k: torch.tensor(i) for i, k in enumerate(keys)})
    out = []
    for path, idx in flatten(tree):
        for i in idx.reshape(-1).tolist():
            out.append((keys[i], path, idx.dim() == 1))
    assert sorted(k for k, _, _ in out) == sorted(keys)
    return out


def param_lineup(cfg):
    model = Z.abstract_params(cfg)
    return line_up(dict(model.named_parameters()),
                   lambda idx: CV.named_to_tree(model, idx))


def cache_lineup(cfg):
    axes = TF.cache_axes(cfg)
    keys = {(i,) + path: None for i, layer in enumerate(axes)
            for path, _ in flatten(layer)}

    def to_tree(idx):
        caches = [{} for _ in axes]
        for (i, *path), v in idx.items():
            node = caches[i]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
        return CV.cache_to_tree(cfg, caches)
    return line_up(keys, to_tree)


def cache_leaf(tree, key):
    return get(tree[key[0]], key[1:])


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch(request):
    a = request.param
    return a, get_config(a), jax_config(a), param_lineup(get_config(a)), \
        cache_lineup(get_config(a))


def test_axes_equal_reference(arch):
    _, cfg, jcfg, params, caches = arch
    port, want = TF.param_axes(cfg), JTF.param_axes(jcfg)
    assert len(port) == len(params)
    for name, path, stacked in params:
        assert (("stage",) if stacked else ()) + port[name] == \
            get(want, path), name
    port, want = TF.cache_axes(cfg), JTF.cache_axes(jcfg)
    for key, path, stacked in caches:
        assert (("stage",) if stacked else ()) + cache_leaf(port, key) == \
            get(want, path), key
    state = adamw.state_axes(port)
    assert state.step == S.P() and tuple(JA.state_axes(want).step) == ()
    assert state.m is state.v is state.master is port


@pytest.mark.parametrize("mesh_key", tuple(MESHES))
def test_pruned_specs_equal_reference(arch, mesh_key):
    """Parameters, AdamW state and a decode_32k cache under the production
    mesh shapes."""
    name, cfg, jcfg, params, caches = arch
    sizes, axes = MESHES[mesh_key]
    am = AbstractMesh(sizes, axes)
    shape = SHAPES["decode_32k"]
    b, s = shape.global_batch, shape.seq_len
    with jax.sharding.use_abstract_mesh(am):
        aparams = JZ.abstract_params(jcfg)
        want = JS.prune_tree_specs(JS.param_specs(JTF.param_axes(jcfg)),
                                   aparams, am)
        want_opt = JS.prune_tree_specs(JA.state_axes(want),
                                       jax.eval_shape(JA.init, aparams), am)
        want_cache = JS.prune_tree_specs(
            JS.param_specs(JTF.cache_axes(jcfg)),
            JZ.abstract_cache(jcfg, b, s), am)
    mesh = M.make_mesh(sizes, axes)
    with S.set_mesh(mesh):
        ptensors, got = D.abstract_param_specs(cfg, mesh)
        got_opt = S.prune_tree_specs(adamw.state_axes(got),
                                     adamw.init(ptensors), mesh)
        got_cache = S.prune_tree_specs(
            S.param_specs(TF.cache_axes(cfg)), Z.abstract_cache(cfg, b, s),
            mesh)
    assert fold(got_opt.step) == fold(want_opt.step) == ()
    for key, path, stacked in params:
        lead = (None,) if stacked else ()
        assert lead + fold(got[key]) == fold(get(want, path)), (name, key)
        for f in ("m", "v", "master"):
            assert lead + fold(getattr(got_opt, f)[key]) == \
                fold(get(getattr(want_opt, f), path)), (name, f, key)
    for key, path, stacked in caches:
        lead = (None,) if stacked else ()
        assert lead + fold(cache_leaf(got_cache, key)) == \
            fold(get(want_cache, path)), (name, key)


# ---------------------------------------------------------------------------
# per-device bytes of a full-size cell
# ---------------------------------------------------------------------------

def ref_bytes(specs, tree, mesh):
    """Per-device bytes of a reference tree under its specs."""
    total = 0
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    for spec, a in zip(leaves, jax.tree.leaves(tree)):
        n = int(np.prod(a.shape, dtype=np.int64)) * np.dtype(a.dtype).itemsize
        for e in spec:
            n //= JS._axis_size(mesh, e)
        total += n
    return total


def ref_argument_bytes(jcfg, shape, am):
    """The reference dry-run's step arguments (its `lower_cell`), sized
    per device from the reference's pruned specs."""
    with jax.sharding.use_abstract_mesh(am):
        aparams = JZ.abstract_params(jcfg)
        pspecs = JS.prune_tree_specs(JS.param_specs(JTF.param_axes(jcfg)),
                                     aparams, am)
        inputs = JZ.input_specs(jcfg, shape)
        total = ref_bytes(pspecs, aparams, am)
        if shape.kind == "train":
            aopt = jax.eval_shape(JA.init, aparams)
            total += ref_bytes(JS.prune_tree_specs(JA.state_axes(pspecs),
                                                   aopt, am), aopt, am)
            ins = inputs["batch"]
        else:
            acache = inputs["cache"]
            total += ref_bytes(JS.prune_tree_specs(
                JS.param_specs(JTF.cache_axes(jcfg)), acache, am), acache, am)
            ins = {"tokens": inputs["tokens"],
                   "positions": inputs["positions"]}
        for k, a in ins.items():
            axes = ("batch", None, "embed_act") if k == "frontend_embeds" \
                else ("batch", None)
            spec = JS.prune_spec_for_shape(JS.logical(*axes), a.shape, am)
            total += ref_bytes([spec], [a], am)
    return total


@pytest.mark.parametrize("arch_name, shape_name", [
    ("qwen3-moe-30b-a3b", "train_4k"), ("whisper-base", "train_4k"),
    ("recurrentgemma-2b", "decode_32k")])
@pytest.mark.parametrize("mesh_key", tuple(MESHES))
def test_argument_bytes_equal_reference_specs(arch_name, shape_name,
                                              mesh_key):
    sizes, axes = MESHES[mesh_key]
    shape = SHAPES[shape_name]
    cfg = get_config(arch_name)
    mesh = M.make_mesh(sizes, axes)
    with S.set_mesh(mesh):
        mem = D.memory_record(cfg, shape, mesh,
                              *D.abstract_param_specs(cfg, mesh))
    assert mem["argument_bytes"] == ref_argument_bytes(
        jax_config(arch_name), shape, AbstractMesh(sizes, axes))


def test_multi_pod_train_cells_not_larger():
    """tests/test_dryrun_artifacts.py's rule, on the stand-in's memory:
    per-device argument bytes of every train cell do not grow from the
    single pod to two."""
    shape = SHAPES["train_4k"]
    for a in ARCH_IDS:
        cfg = get_config(a)
        arg = {}
        for mp in (False, True):
            mesh = M.make_production_mesh(multi_pod=mp)
            with S.set_mesh(mesh):
                arg[mp] = D.memory_record(
                    cfg, shape, mesh,
                    *D.abstract_param_specs(cfg, mesh))["argument_bytes"]
        assert arg[True] <= arg[False], (a, arg)
