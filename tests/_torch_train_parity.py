"""Shared by the port's training tests: the reference's loss and gradients
on an architecture's smoke config, and the port's `loss_fn` held to them
leaf for leaf (the bounds are stated in `tests/test_torch_train.py`)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core  # noqa: F401  (x64 for the reference, as its suite)
from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as JTF
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import convert as CV
from repro_torch.models import transformer as TF

TOL = 5e-2
GRAD_REL = 5e-2
B, S = 2, 16
# run op by op: XLA's fusion of the SSD moves the reference's own gradients
EAGER = ("mamba2-1.3b",)


def bf16_array(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16))


def port(x):
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(params, batch, loss, aux metrics, grads) of the reference."""
    jcfg = jax_smoke(arch)
    params = jax.jit(lambda k: JTF.init_params(jcfg, k))(jax.random.key(1))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if jcfg.enc_layers or jcfg.vision_patches:
        n = jcfg.enc_frames if jcfg.enc_layers else jcfg.vision_patches
        batch["frontend_embeds"] = bf16_array(
            rng.standard_normal((B, n, jcfg.d_model)))
    f = jax.value_and_grad(lambda p, b: JTF.loss_fn(p, jcfg, b),
                           has_aux=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if arch in EAGER:
        with jax.disable_jit():
            (loss, metrics), grads = f(params, jb)
    else:
        (loss, metrics), grads = jax.jit(f)(params, jb)
    return params, batch, loss, metrics, grads


def check_loss_and_grads(arch, monkeypatch):
    """The port's loss, xent and aux within TOL of the reference's, and every
    gradient leaf finite and within GRAD_REL in relative L2 norm."""
    params, batch, loss, metrics, grads = _reference(arch)
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        monkeypatch.setattr(
            A, "flash_attention", lambda q, k, v, causal=True, window=0:
            A.plain_attention(q, k, v, causal=causal, window=window or None))
    model = CV.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    model.requires_grad_(True)
    got, m = TF.loss_fn(model, {k: port(v) for k, v in batch.items()})
    got.backward()
    for name, g, w in (("loss", got, loss), ("xent", m["xent"],
                                             metrics["xent"]),
                       ("aux", m["aux"], metrics["aux"])):
        assert g.dtype == torch.float32
        assert abs(float(g.detach()) - float(w)) <= TOL, (arch, name)
    tree = CV.grads_to_tree(model)
    leaves = jax.tree_util.tree_leaves_with_path(grads)
    assert len(leaves) == len(jax.tree.leaves(tree))
    for path, want in leaves:
        g = tree
        for k in path:
            g = g[k.key]
        want = np.asarray(want).astype(np.float64)
        assert tuple(g.shape) == want.shape, (arch, path)
        g = g.detach().float().numpy().astype(np.float64)
        assert np.all(np.isfinite(g)), (arch, path)
        rel = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= GRAD_REL, (arch, jax.tree_util.keystr(path), rel)
