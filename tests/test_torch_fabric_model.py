"""PyTorch port, the TPU-fabric cost model against the JAX reference's.

``repro_torch.core.fabric_model``, ``core.autotune``, ``runtime.straggler``
and ``studies.fabric`` held to ``repro.core.fabric_model``,
``repro.core.autotune``, ``repro.runtime.straggler`` and
``benchmarks/bench_fabric.py`` on the CPU:

* `predict_collective` on simulated pods of 4 x 4, 8 x 8 and 2 x (4 x 4)
  chips, every collective kind along both axes: every schedule the
  estimate resolves (arrive, start, depart, complete, rounds, converged)
  equals the reference engine's on the reference's own tables, and every
  `CollectiveEstimate` field is equal;
* the reference's own fabric and autotune tests
  (``tests/test_sharding_rules.py``), run on the port;
* `autotune` with the engine's collective term off and on: the ranking and
  every `Score` field equal;
* `StragglerDetector` verdict sequences and state on seeded step-time
  series, `mitigation_decision` on a grid, `estimate_step_impact`'s dict;
* ``studies.fabric.run(quick=True)``: row names and ``derived`` strings.

Tolerance: exact (integer picoseconds; the floats are the same Python
expressions on the same integers).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
import benchmarks.bench_fabric as RBF  # noqa: E402
from repro.core import autotune as RA  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import fabric_model as RF  # noqa: E402
from repro.runtime import straggler as RS  # noqa: E402
from repro_torch.core import autotune as PA  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core import fabric_model as PF  # noqa: E402
from repro_torch.runtime import straggler as PS  # noqa: E402
from repro_torch.studies import fabric as PBF  # noqa: E402
from repro_torch.studies.common import StudyLog  # noqa: E402

MB = 1 << 20
FABRICS = {"4x4": (4, 4, 1), "8x8": (8, 8, 1), "2x4x4": (4, 4, 2)}
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
CASES = [(f, k, ax) for f in FABRICS
         for k in KINDS + (("pod_all_reduce",) if FABRICS[f][2] > 1 else ())
         for ax in "xy"]
DENSE = dict(n_layers=32, d_model=4096, d_ff=14336, n_heads=32, n_kv=8,
             head_dim=128, vocab=128256, batch=256, seq=4096)
MOE = dict(n_layers=64, d_model=6144, d_ff=32768, n_heads=48, n_kv=8,
           head_dim=128, vocab=131072, batch=256, seq=4096, n_experts=8,
           top_k=2)
DECODE = dict(DENSE, batch=64, decode=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fabrics():
    """name -> (reference fabric, its graph, port fabric, its graph)."""
    out = {}
    for name, (nx, ny, pods) in FABRICS.items():
        rf, pf = RF.TPUFabric(nx, ny, pods), PF.TPUFabric(nx, ny, pods)
        out[name] = (rf, rf.build(), pf, pf.build())
    return out


def fields(x):
    return dataclasses.astuple(x)


@pytest.mark.parametrize("fabric,kind,axis", CASES)
def test_collective_schedule_and_estimate_equal_reference(fabrics, fabric,
                                                          kind, axis,
                                                          monkeypatch):
    rf, rg, pf, pg = fabrics[fabric]
    calls = []
    orig = RF.simulate_transfers

    def recorded_ref(graph, pairs, nbytes):
        calls.append((pairs, nbytes))
        return orig(graph, pairs, nbytes)

    monkeypatch.setattr(RF, "simulate_transfers", recorded_ref)
    scheds = []

    def recorded_port(hops, channels, issue_ps):
        scheds.append(PE.simulate(hops, channels, issue_ps))
        return scheds[-1]

    nbytes = 24 * MB + 7
    want = RF.predict_collective(rf, rg, kind, axis, nbytes)
    got = PF.predict_collective(pf, pg, kind, axis, nbytes, device="cpu",
                                simulate_fn=recorded_port)
    assert fields(got) == fields(want)
    assert len(calls) == len(scheds) == 1
    (pairs, nb), sched = calls[0], scheds[0]
    ref = RE.simulate(RF._transfer_hops(rg, pairs, nb), RE.make_channels(rg),
                      jnp.zeros(len(pairs), jnp.int64))
    for f in ("arrive", "start", "depart", "complete"):
        assert np.array_equal(getattr(sched, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    assert sched.rounds == int(ref.rounds)
    assert sched.converged == bool(ref.converged)


def test_transfer_hops_dtypes_and_device(fabrics):
    _, _, pf, pg = fabrics["4x4"]
    hops = PF._transfer_hops(pg, PF.ring_neighbors(pf, "x"), 1000,
                             device="cpu")
    assert {f: getattr(hops, f).dtype for f in hops._fields
            if getattr(hops, f) is not None} == {
        "channel": torch.int32, "nbytes": torch.int64,
        "direction": torch.int8, "row": torch.int32,
        "fixed_after_ps": torch.int64, "is_payload": torch.bool,
        "valid": torch.bool}
    assert bool((hops.row == -1).all())
    assert all(getattr(hops, f).device.type == "cpu" for f in
               ("channel", "nbytes", "valid"))


def test_unknown_collective_raises(fabrics):
    _, _, pf, pg = fabrics["4x4"]
    with pytest.raises(ValueError, match="unknown collective"):
        PF.predict_collective(pf, pg, "broadcast", "x", MB, device="cpu")


# the reference's own tests (tests/test_sharding_rules.py), on the port

def test_fabric_ring_matches_alpha_beta():
    fab = PF.TPUFabric(nx=4, ny=4)
    g = fab.build()
    est = PF.predict_collective(fab, g, "all_reduce", "x", 8 << 20,
                                device="cpu")
    ana = PF.analytic_ring_seconds(8 << 20, 4)
    assert abs(est.seconds - ana) / ana < 0.05


def test_all_to_all_shows_contention():
    fab = PF.TPUFabric(nx=8, ny=8)
    g = fab.build()
    est = PF.predict_collective(fab, g, "all_to_all", "x", 32 << 20,
                                device="cpu")
    naive = (32 << 20) / 8 * 7 / (50_000 * 1e6 * 2)
    assert est.seconds > 1.5 * naive  # torus contention is real


def test_autotune_filters_infeasible_and_ranks():
    dims = PA.WorkloadDims(**DENSE)
    scores = PA.autotune(dims, PF.TPUFabric(16, 16), device="cpu")
    assert scores, "no feasible layout"
    assert scores[0].step_s <= scores[-1].step_s
    # ddp (unsharded state) must not be the winner for an 8B model
    assert scores[0].layout.name != "ddp"


@pytest.mark.parametrize("use_engine", [False, True])
@pytest.mark.parametrize("dims", ["dense", "moe", "decode"])
@pytest.mark.parametrize("fabric", ["4x4", "2x4x4"])
def test_autotune_scores_equal_reference(fabrics, fabric, dims, use_engine):
    rf, rg, pf, pg = fabrics[fabric]
    kw = {"dense": DENSE, "moe": MOE, "decode": DECODE}[dims]
    want = RA.autotune(RA.WorkloadDims(**kw), rf, graph=rg,
                       use_engine=use_engine)
    got = PA.autotune(PA.WorkloadDims(**kw), pf, graph=pg,
                      use_engine=use_engine, device="cpu")
    assert [s.layout.name for s in got] == [s.layout.name for s in want]
    for g, w in zip(got, want):
        assert dataclasses.asdict(g.layout) == dataclasses.asdict(w.layout)
        assert (g.compute_s, g.memory_s, g.collective_s, g.step_s,
                g.hbm_bytes_per_chip, g.detail, g.bound) == (
            w.compute_s, w.memory_s, w.collective_s, w.step_s,
            w.hbm_bytes_per_chip, w.detail, w.bound)
    assert PA.WorkloadDims(**kw).params == RA.WorkloadDims(**kw).params
    assert PA.WorkloadDims(**kw).active_params == \
        RA.WorkloadDims(**kw).active_params


def _step_times(seed):
    """A seeded step-time series over four workers: a noisy baseline, a
    sustained straggler from step 40, and isolated spikes."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(120):
        worker = int(rng.integers(0, 4))
        t = 1.0 + 0.02 * float(rng.standard_normal())
        if worker == 3 and step >= 40:
            t *= 1.0 + 2.0 * float(rng.random())
        elif rng.random() < 0.05:
            t *= 4.0
        out.append((worker, t))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("patience", [2, 5])
def test_straggler_verdicts_equal_reference(seed, patience):
    ref = RS.StragglerDetector(patience=patience)
    port = PS.StragglerDetector(patience=patience)
    series = _step_times(seed)
    want = [ref.observe(w, t) for w, t in series]
    got = [port.observe(w, t) for w, t in series]
    assert got == want
    assert "straggler" in got
    assert (port.mean, port.var, port.n, port.strikes) == (
        ref.mean, ref.var, ref.n, ref.strikes)


def test_straggler_detector_flags_sustained_outliers():
    det = PS.StragglerDetector(patience=3)
    verdicts = [det.observe(0, 1.0) for _ in range(20)]
    assert all(v == "ok" for v in verdicts)
    verdicts = [det.observe(1, 3.0) for _ in range(4)]
    assert verdicts[-1] == "straggler"


def test_mitigation_decision_equals_reference_on_a_grid():
    for slowdown in (0.9, 1.0, 1.01, 1.019, 1.02, 1.04, 1.1, 1.5, 4.0):
        for cost in (0.0, 1.0, 50.0, 400.0):
            for remaining in (0, 10, 200, 1000, 20_000):
                assert PS.mitigation_decision(slowdown, cost, remaining) == \
                    RS.mitigation_decision(slowdown, cost, remaining)
    assert PS.mitigation_decision(1.01, 50, 1000) == "ignore"
    assert PS.mitigation_decision(1.04, 50, 1000) == "rebalance"
    assert PS.mitigation_decision(1.5, 50, 1000) == "checkpoint_evict"


@pytest.mark.parametrize("fabric", ["4x4", "8x8"])
def test_step_impact_equals_reference(fabrics, fabric):
    rf, rg, pf, pg = fabrics[fabric]
    kw = dict(grad_bytes_per_chip=600 << 20, slow_factor=4.0, compute_s=0.9)
    assert PS.estimate_step_impact(pf, pg, device="cpu", **kw) == \
        RS.estimate_step_impact(rf, rg, **kw)


def test_fabric_study_quick_rows_equal_reference():
    want = RBF.run(quick=True)
    log = StudyLog()
    got = PBF.run(quick=True, device="cpu", log=log)
    assert [r.name for r in got] == [r.name for r in want]
    assert [r.derived for r in got] == [r.derived for r in want]
    # one schedule a collective, each converged within its bound
    assert [r.label for r in log.runs] == [
        "all_reduce/16MB", "all_reduce/128MB", "all_to_all/64MB"]
    assert all(r.schedule.converged for r in log.runs)
    assert all(r.schedule.rounds <= PE.round_bound(r.hops)
               for r in log.runs)
