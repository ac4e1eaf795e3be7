"""PyTorch port, the GPipe schedule (`parallel.pipeline_par`) against the
JAX reference's and against sequential application, on the CPU.

* The reference's own case (tests/test_pipeline_parallel.py: S 4 stages, D
  16, 8 rows, M 4 microbatches, ``tanh(x @ w)``): the reference runs in a
  subprocess with 4 placeholder devices, as its test runs it; the port's
  output equals it within ``1e-5`` (float32, the same products in another
  library) and equals the stages applied in order bit for bit.
* recurrentgemma-2b's smoke config at two periods, one period a stage, two
  stages, M 2: each microbatch's output equals the stages applied to it in
  order bit for bit (the same ops on the same inputs).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.parallel.pipeline_par import pipeline_forward  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, D, ROWS, M = 4, 16, 8, 4

REFERENCE = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro.jax_compat import AxisType, make_mesh
from repro.parallel.pipeline_par import pipeline_forward

mesh = make_mesh((4,), ("stage",), axis_types=(AxisType.Auto,))
S, D = 4, 16
rng = np.random.default_rng(0)
ws = jnp.asarray(rng.normal(0, 0.5, (S, D, D)).astype(np.float32))
x = jnp.asarray(rng.normal(0, 1, (8, D)).astype(np.float32))
out = pipeline_forward(lambda w, x: jnp.tanh(x @ w), ws, x, mesh=mesh,
                       n_microbatches=4)
print("PIPELINE_OUT", json.dumps(np.asarray(out).tolist()))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def reference_case():
    rng = np.random.default_rng(0)
    ws = rng.normal(0, 0.5, (S, D, D)).astype(np.float32)
    x = rng.normal(0, 1, (ROWS, D)).astype(np.float32)
    return torch.from_numpy(ws), torch.from_numpy(x)


def test_reference_case_equals_reference_and_sequential():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True,
                       text=True, timeout=300, env=env)
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("PIPELINE_OUT ")]
    assert line, r.stdout + r.stderr
    want = np.asarray(json.loads(line[0].split(" ", 1)[1]), np.float32)

    ws, x = reference_case()
    mesh = make_mesh((S,), ("stage",))
    got = pipeline_forward(lambda w, h: torch.tanh(h @ w), list(ws), x,
                           mesh=mesh, n_microbatches=M)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    seq = x
    for s in range(S):
        seq = torch.tanh(seq @ ws[s])
    assert torch.equal(got, seq)


def test_schedule_runs_only_valid_pairs_and_refuses_ragged_batches():
    calls = []

    def stage_fn(s, h):
        calls.append((s, int(h[0, 0])))
        return h + 1

    x = torch.arange(ROWS, dtype=torch.float32)[:, None] * 100
    mesh = make_mesh((S,), ("stage",))
    out = pipeline_forward(stage_fn, list(range(S)), x, mesh=mesh,
                           n_microbatches=M)
    assert torch.equal(out, x + S)
    # S * M stage calls, stage s taking microbatch t - s at tick t (row 0
    # of microbatch m holds 200 m, plus 1 a stage)
    assert [(s, (v - s) // 200) for s, v in calls] == [
        (s, t - s) for t in range(S + M - 1) for s in range(S)
        if 0 <= t - s < M]
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward(stage_fn, list(range(S)), x[:7], mesh=mesh,
                         n_microbatches=M)
    with pytest.raises(ValueError, match="stage"):
        pipeline_forward(stage_fn, list(range(S - 1)), x, mesh=mesh,
                         n_microbatches=M)


def test_recurrentgemma_periods_bit_equal_per_microbatch():
    smoke = get_smoke_config("recurrentgemma-2b")
    per = len(smoke.pattern)
    cfg = dataclasses.replace(smoke, n_layers=2 * per)
    model = TF.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    layers = list(model.layers)
    stages = [layers[:per], layers[per:]]
    rows, seq = 2, 40          # past the smoke window of 32
    tokens = torch.randint(0, cfg.vocab, (rows, seq),
                           generator=torch.Generator().manual_seed(1))
    x = TF.embed(model.embed.tok, tokens)
    positions = torch.arange(seq)[None]

    def stage_fn(blocks, h):
        for blk in blocks:
            h, _ = TF._apply_block(blk, h, positions, cfg, mode="forward")
        return h

    mesh = make_mesh((2,), ("stage",))
    with torch.no_grad():
        got = pipeline_forward(stage_fn, stages, x, mesh=mesh,
                               n_microbatches=rows)
        for i in range(rows):
            want = x[i:i + 1]
            for blocks in stages:
                want = stage_fn(blocks, want)
            assert torch.equal(got[i:i + 1], want), i
    assert got.shape == x.shape and got.dtype == x.dtype
    assert bool(torch.isfinite(got.float()).all())
