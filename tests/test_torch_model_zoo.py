"""PyTorch port, `models.model_zoo` against ``repro.models.model_zoo``: for
all ten architectures at their full published configs, the ``meta``
parameters, caches and input stand-ins have the reference's
``jax.eval_shape`` shapes and dtypes, leaf for leaf through `models.convert`'s
key map, for every applicable `SHAPES` entry; the serving steps run at smoke
size, the training step is refused; and the serving launcher runs each
architecture the reference's launcher runs.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,  # noqa: E402
                                 get_smoke_config, shape_applicable)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert as CV  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ref_leaves(tree):
    """path -> (shape, dtype name) of a reference tree of ShapeDtypeStructs
    (plain ints kept as they are)."""
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        key = tuple(k.key for k in path)
        out[key] = x if isinstance(x, int) else (tuple(x.shape),
                                                 np.dtype(x.dtype).name)
    return out


def port_leaves(tree, prefix=()):
    out = {}
    for name, x in tree.items():
        if isinstance(x, dict):
            out.update(port_leaves(x, prefix + (name,)))
        elif isinstance(x, int):
            out[prefix + (name,)] = x
        else:
            assert x.device.type == "meta", (prefix, name)
            out[prefix + (name,)] = (tuple(x.shape),
                                     str(x.dtype).split(".")[1])
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_shapes_equal_reference_eval_shape(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    assert port_leaves(CV.params_to_tree(Z.abstract_params(cfg))) == \
        ref_leaves(JZ.abstract_params(jcfg)), "params"
    checked = 0
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        want = ref_leaves(JZ.input_specs(jcfg, shape))
        specs = Z.input_specs(cfg, shape)
        if "cache" in specs:
            specs["cache"] = CV.cache_to_tree(cfg, specs["cache"])
            assert port_leaves(CV.cache_to_tree(cfg, Z.abstract_cache(
                cfg, shape.global_batch, shape.seq_len))) == ref_leaves(
                    JZ.abstract_cache(jcfg, shape.global_batch,
                                      shape.seq_len)), name
        assert port_leaves(specs) == want, name
        checked += 1
    assert checked == (4 if cfg.sub_quadratic else 3)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "whisper-base",
                                  "phi-3-vision-4.2b"])
def test_step_fns_serve_and_training_is_refused(arch):
    cfg = get_smoke_config(arch)
    model = Z.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    fe = None
    if cfg.enc_layers or cfg.vision_patches:
        n = cfg.enc_frames if cfg.enc_layers else cfg.vision_patches
        fe = torch.randn(2, n, cfg.d_model).to(torch.bfloat16)
    logits, cache = Z.step_fn(cfg, "prefill")(model, toks, 16,
                                              frontend_embeds=fe)
    logits, _ = Z.step_fn(cfg, "decode")(
        model, cache, toks[:, :1], torch.full((2, 1), 12, dtype=torch.int32))
    assert tuple(logits.shape) == (2, 1, cfg.vocab)
    assert not bool(torch.isnan(logits).any())
    with pytest.raises(NotImplementedError, match="loss_fn"):
        Z.step_fn(cfg, "train")
    with pytest.raises(NotImplementedError, match="training slice"):
        Z.train_step_fn(cfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_launcher_runs_every_arch_the_reference_runs(arch, capsys):
    """`python -m repro_torch.launch.serve --arch A --device cpu` at smoke
    size; whisper-base is refused, as the reference's launcher fails on it
    (its `Server` prefills with no frame embeddings)."""
    argv = ["--arch", arch, "--device", "cpu", "--requests", "3",
            "--max-new", "3", "--slots", "2"]
    if get_config(arch).enc_layers:
        with pytest.raises(ValueError, match="encoder-decoder"):
            serve.main(argv)
        return
    serve.main(argv)
    out = capsys.readouterr().out
    assert f"arch={get_smoke_config(arch).name} served 3 reqs" in out
