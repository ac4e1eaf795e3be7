"""PyTorch port, the training loss against the JAX reference on the CPU:
`layers.softmax_xent` with and without a mask, and `transformer.loss_fn`
with every gradient leaf against ``jax.value_and_grad`` of the reference's
``loss_fn`` for each of the ten architectures' smoke configs, from the
reference's weights carried across by `models.convert`
(`convert.grads_to_tree` lays the port's gradients out as the reference's
pytree).

The port trains through its attention kernel's autograd function (its
plain forward and backward on the CPU) and its RG-LRU scan's; the
reference differentiates its plain attention (softmax weights rounded to
bf16) and its associative scan.  Tolerances:
* `softmax_xent`: ``1e-6`` relative (float32 logsumexp, summed in another
  order);
* the loss, its cross entropy and its aux loss: ``5e-2`` absolute, the bf16
  tolerance of the reference's own suite;
* each gradient leaf: ``5e-2`` in relative L2 norm (the parameters and their
  gradients are bf16; the measured worst leaf is 0.041, recurrentgemma's
  ``w_r``, the others at most 0.029).

The reference runs compiled, except for mamba2-1.3b: XLA's fusion of its
SSD moves the reference's own gradients by 0.11–0.25 in relative L2 from
the same reference run op by op (``jax.disable_jit``), and the port follows
the op-by-op source (within 0.006); that case, 20 s of the reference op by
op, runs in `tests/test_torch_train_kernels.py` beside the SSD's other
gradient checks, so that each file stays under a minute on one thread. The
MoE architectures run with the port's attention rounded as the reference's
(the `rounded_as_reference` fixture of `tests/test_torch_moe.py`), so that
both sides route alike: a near-tied expert choice flipped by the kernel's
float32 softmax weights would move a token's gradient by far more than the
bound, and the kernel's path is held to that rounding by
``test_torch_moe.py -k near_ties``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.models import convert as CV  # noqa: E402
from repro_torch.models import layers as TFL  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from _torch_train_parity import (B, EAGER, S, _reference,  # noqa: E402
                                 bf16_array, check_loss_and_grads, port)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_equals_reference(masked):
    rng = np.random.default_rng(0)
    logits = bf16_array(rng.standard_normal((3, 7, 50)) * 4)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.int32) if masked else None
    want = float(JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask)))
    got = TFL.softmax_xent(port(logits), port(labels),
                           None if mask is None else port(mask))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    if masked:
        none = TFL.softmax_xent(port(logits), port(labels),
                                torch.zeros(3, 7, dtype=torch.int32))
        assert float(none) == 0.0


def test_loss_fn_weighs_the_aux_loss():
    """loss = xent + 0.01 aux on an MoE model, and aux is the layers' sum."""
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    model = TF.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        loss, m = TF.loss_fn(model, {"tokens": toks, "labels": toks})
    assert float(m["aux"]) > 0
    assert float(loss) == float(m["xent"] + 0.01 * m["aux"])


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in EAGER])
def test_loss_and_every_gradient_leaf_equal_reference(arch, monkeypatch):
    check_loss_and_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-2b"])
def test_gradient_dtypes_follow_the_parameters(arch):
    params, batch, _, _, grads = _reference(arch)
    cfg = get_smoke_config(arch)
    model = CV.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    model.requires_grad_(True)
    TF.loss_fn(model, {k: port(v) for k, v in batch.items()})[0].backward()
    tree = CV.grads_to_tree(model)
    for path, want in jax.tree_util.tree_leaves_with_path(grads):
        g = tree
        for k in path:
            g = g[k.key]
        assert str(g.dtype).split(".")[1] == np.asarray(want).dtype.name, \
            jax.tree_util.keystr(path)
