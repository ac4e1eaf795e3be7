"""PyTorch port, the examples whose modules are all ported, against the
examples themselves.

* ``studies.fabric_autotune``, ``studies.coherence_fabric_demo`` and
  ``studies.link_reliability_demo`` print what ``examples/fabric_autotune.py``,
  ``examples/coherence_fabric_demo.py`` and
  ``examples/link_reliability_demo.py`` print, line for line.  The
  autotune example runs at its own size (a 16 x 16 pod); the coherence
  demo's stream (600 requests) and the reliability demo's bus (1,200
  requests) are cut the same way on both sides by monkeypatching, as
  ``test_torch_paper_studies.py`` cuts the topology explorer.
* ``studies.serve_decode`` on the example's weights (the JAX init carried
  across by `models.convert`): the same request count, decode ticks and
  tokens as the example's `Server`, its first line printed alike, and the
  greedy tokens equal up to near ties, as ``test_torch_model.py`` holds the
  port's `Server` against the reference's.

Tolerance: exact for the printouts (integer picoseconds formatted the same
way); greedy tokens as in ``test_torch_model.py``: where they first differ,
the reference's logits rank the port's token within
``2 * (5e-2 + 5e-2 * |top logit|)`` of their top.
"""

import contextlib
import functools
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import convert as CV  # noqa: E402
from repro_torch.studies import coherence_fabric_demo as PCD  # noqa: E402
from repro_torch.studies import fabric_autotune as PFA  # noqa: E402
from repro_torch.studies import link_reliability_demo as PLR  # noqa: E402
from repro_torch.studies import serve_decode as PSD  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N_COHERENCE = 90    # the coherence demo's requests (600)
N_BUS = 300         # the reliability demo's requests per bus (1,200)
TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return out.getvalue(), result


def _example(name):
    """Load ``examples/<name>.py`` as a module (its top-level code runs);
    returns (module, what loading it printed)."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    printed, _ = _printed(spec.loader.exec_module, mod)
    return mod, printed


def test_fabric_autotune_prints_what_the_example_prints():
    _, want = _example("fabric_autotune")
    got, _ = _printed(PFA.main, "cpu")
    assert got.splitlines() == want.splitlines()
    assert "factor 4.80x" in got


def test_coherence_fabric_demo_prints_what_the_example_prints(monkeypatch):
    ex, _ = _example("coherence_fabric_demo")
    for mod in (ex, PCD):
        monkeypatch.setattr(mod, "N", N_COHERENCE)
    want, _ = _printed(ex.load_ramp)
    got, _ = _printed(PCD.load_ramp, "cpu")
    assert got.splitlines() == want.splitlines()
    want, _ = _printed(ex.trace_mode)
    got, _ = _printed(PCD.trace_mode, "cpu")
    assert got.splitlines() == want.splitlines()


def test_link_reliability_demo_prints_what_the_example_prints(monkeypatch):
    ex, _ = _example("link_reliability_demo")
    for mod in (ex, PLR):
        monkeypatch.setattr(mod, "build",
                            functools.partial(mod.build, n=N_BUS))
    for name in ("tail_sweep", "retraining_demo"):
        want, _ = _printed(getattr(ex, name))
        got, _ = _printed(getattr(PLR, name), "cpu")
        assert got.splitlines() == want.splitlines(), name


def test_serve_decode_tokens_equal_the_example_up_to_near_ties():
    ex, want = _example("serve_decode")
    cfg = get_smoke_config(PSD.ARCH)
    model = CV.params_from_numpy(cfg, jax.tree.map(np.asarray, ex.params),
                                 device="cpu")
    got, (reqs, stats, _) = _printed(PSD.main, "cpu", model=model)
    assert got.splitlines()[0] == want.splitlines()[0]
    assert stats["ticks"] == 14 and stats["generated"] == 42
    assert [len(r.prompt) for r in reqs] == [len(r.prompt)
                                             for r in ex.requests]
    for pr, jr in zip(reqs, ex.requests):
        assert np.array_equal(pr.prompt, jr.prompt)
        assert len(pr.out) == len(jr.out) == 8 and pr.done
        diff = [i for i, (a, b) in enumerate(zip(jr.out, pr.out)) if a != b]
        if not diff:
            continue
        k = diff[0]
        # the reference's logits at step k, after the common prefix
        seq = np.concatenate([jr.prompt, np.asarray(jr.out[:k], np.int32)])
        ref_logits, _, _ = JTF.forward(ex.params, ex.cfg,
                                       jnp.asarray(seq[None]))
        row = np.asarray(ref_logits).astype(np.float32)[0, -1]
        top = float(row.max())
        margin = 2 * (TOL + TOL * abs(top))
        assert top - float(row[pr.out[k]]) <= margin, (
            f"request {jr.rid}: first difference at token {k} is not a near "
            f"tie (reference top {top}, port's token scores "
            f"{float(row[pr.out[k]])}, tolerance {margin})")


def test_serve_decode_seeded_weights_are_reproducible():
    _, (a, _, _) = _printed(PSD.main, "cpu", seed=3)
    _, (b, _, _) = _printed(PSD.main, "cpu", seed=3)
    assert [r.out for r in a] == [r.out for r in b]
    assert all(len(r.out) == 8 for r in a)
