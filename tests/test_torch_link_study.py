"""PyTorch port, stacked sweeps and the link-layer studies against the JAX
reference, at small sizes on the CPU.

* `simulate_stacked` equals ``jax.vmap(simulate)`` on the BER sweep's
  stacked ``replay_ppm`` tables: every member's schedule and its own
  ``rounds`` / ``converged`` / ``residual_ps``; on fork/join members it
  equals the reference's ``simulate`` of each member alone (row ids
  offset per member), and a truncated budget leaves the same per-member
  residuals.
* `studies.link_layer` / `studies.link_reliability`: each ``run_*``
  returns what the reference's ``benchmarks/bench_link_*.py`` returns
  (≤ 200 requests, 3 BERs), and ``run(quick=True)`` with the sizes cut the
  same way on both sides gives the same rows (names and ``derived``).
* `studies.link_explorer.kernel_grid` equals the example's grid.

Tolerance: exact for every integer output and every schedule; percentiles
(float64 linear interpolation, the same index arithmetic as
``jnp.percentile``) within ``rtol=1e-12``; the flit grid ``rtol=1e-6``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.core import engine as RE  # noqa: E402
import benchmarks.bench_link_layer as RL  # noqa: E402
import benchmarks.bench_link_reliability as RR  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.studies import link_layer as PL  # noqa: E402
from repro_torch.studies import link_reliability as PR  # noqa: E402
from repro_torch.studies.common import StudyLog  # noqa: E402
from test_engine import _join_case  # noqa: E402

N = 150
BERS3 = (0.0, 1e-6, 1e-5)
FIELDS = ("start", "depart", "arrive", "complete")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_wl(wl):
    return (P.hops_from_arrays(wl.hops, device="cpu"),
            P.channels_from_arrays(wl.channels, device="cpu"),
            P.issue_from_array(wl.issue_ps, device="cpu"))


def test_stacked_sweep_equals_vmapped_reference():
    wl = RL._bus_workload(RL.PCIE6_X16_RAW_MBPS, RL.FlitConfig("flit256"), N,
                          read_ratio=0.5)
    link = ~np.asarray(wl.channels.flit_size == 0)
    ppms = [RL.replay_overhead_ppm(b, "flit256") for b in BERS3]

    def one(ppm):
        ch = wl.channels._replace(
            replay_ppm=jnp.where(jnp.asarray(link), ppm, 0))
        return RE.simulate(wl.hops, ch, wl.issue_ps)

    ref = jax.vmap(one)(jnp.asarray(ppms, jnp.int64))
    hops, ch, issue = _port_wl(wl)
    m = len(ppms)
    chans = P.stack_members([ch._replace(replay_ppm=torch.where(
        ch.flit_size != 0, torch.full_like(ch.replay_ppm, p), 0))
        for p in ppms])
    got = P.simulate_stacked(P.stack_members([hops] * m), chans,
                             torch.stack([issue] * m))
    for f in FIELDS:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    assert list(got.rounds) == np.asarray(ref.rounds).tolist()
    assert list(got.converged) == np.asarray(ref.converged).tolist()
    assert list(got.residual_ps) == np.asarray(ref.residual_ps).tolist()


def _join_members(seed, m=3):
    hops, ch, issue = _join_case(seed)
    rng = np.random.default_rng(seed)
    members = []
    for i in range(m):
        bw = np.asarray(ch.bw_MBps) * (i + 1)
        jitter = rng.integers(0, 3_000, np.asarray(issue).shape[0])
        members.append((hops, ch._replace(bw_MBps=jnp.asarray(bw)),
                        jnp.asarray(np.asarray(issue) + i * jitter)))
    return members


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_rounds", [0, 3])
def test_stacked_join_members_equal_reference_alone(seed, max_rounds):
    members = _join_members(seed)
    port = [(P.hops_from_arrays(h, device="cpu"),
             P.channels_from_arrays(c, device="cpu"),
             P.issue_from_array(i, device="cpu")) for h, c, i in members]
    got = P.simulate_stacked(P.stack_members([p[0] for p in port]),
                             P.stack_members([p[1] for p in port]),
                             torch.stack([p[2] for p in port]),
                             P.SimOptions(max_rounds=max_rounds))
    assert P.round_bound(P.stack_members([p[0] for p in port])) == max(
        RE.round_bound(h) for h, _, _ in members)
    for i, (h, c, iss) in enumerate(members):
        ref = RE.simulate(h, c, iss, RE.SimOptions(max_rounds=max_rounds))
        one = P.member(got, i)
        for f in FIELDS:
            assert np.array_equal(getattr(one, f).numpy(),
                                  np.asarray(getattr(ref, f))), (i, f)
        assert one.rounds == int(ref.rounds)
        assert one.converged == bool(ref.converged)
        assert one.residual_ps == int(ref.residual_ps)


def test_stacked_stats_equal_member_stats():
    wl = P.build_workload(
        P.single_bus(n_mems=2).build(),
        [P.RequesterSpec(node=0, n_requests=60, targets=[2, 3],
                         issue_interval_ps=2_000, seed=4)],
        warmup_frac=0.0, device="cpu")
    hops = P.stack_members([wl.hops] * 2)
    ch = P.stack_members([wl.channels, wl.channels._replace(
        bw_MBps=wl.channels.bw_MBps // 2)])
    issue = torch.stack([wl.issue_ps] * 2)
    s = P.simulate_stacked(hops, ch, issue)
    rs = P.stacked_request_stats(hops, s, issue,
                                 torch.stack([wl.payload_bytes] * 2),
                                 torch.stack([wl.measured] * 2))
    cs = P.stacked_channel_stats(hops, s, ch)
    for i in range(2):
        alone = P.simulate(wl.hops, P.member(ch, i), wl.issue_ps)
        assert alone.rounds == s.rounds[i]
        r = P.request_stats(wl.hops, alone, wl.issue_ps, wl.payload_bytes,
                            wl.measured)
        c = P.channel_stats(wl.hops, alone, P.member(ch, i))
        for key in r:
            assert torch.equal(rs[i][key], r[key]), key
        for key in c:
            assert torch.equal(cs[i][key], c[key]), key
    assert rs[0]["bandwidth_MBps"] > rs[1]["bandwidth_MBps"]


# ---------------------------------------------------------------------------
# the studies, function by function and row by row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gen", ["pcie5_bytes", "pcie5_flit68",
                                 "pcie6_flit256"])
def test_generation_equals_reference(gen):
    assert PL.run_generation(gen, N, device="cpu") == \
        RL.run_generation(gen, N)


def test_efficiency_and_ber_sweep_equal_reference():
    assert PL.run_efficiency_check(N, device="cpu") == \
        RL.run_efficiency_check(N)
    log = StudyLog()
    sweep = PL.run_ber_sweep(BERS3, N, device="cpu", log=log)
    assert sweep == RL.run_ber_sweep(BERS3, N)
    (run,) = [r for r in log.runs if r.stacked]
    assert tuple(run.hops.channel.shape[:1]) == (len(BERS3),)
    assert set(log.seconds) == {"lower", "verify", "simulate"}


def test_tail_sweep_equals_reference():
    bers = (0.0, 1e-5, 1e-4)
    got = PR.run_tail_sweep(bers, N, device="cpu")
    ref = RR.run_tail_sweep(bers, N)
    for g, r in zip(got, ref):
        assert g["ber"] == r["ber"]
        for key in r:
            np.testing.assert_allclose(g[key], r[key], rtol=1e-12, atol=0)


def test_zero_ber_and_retrain_stall_equal_reference():
    assert PR.run_zero_ber_equivalence(N, device="cpu") is True
    assert RR.run_zero_ber_equivalence(N)
    assert PR.run_retrain_stall(n=N, device="cpu") == \
        RR.run_retrain_stall(n=N)


def test_percentile_equals_jnp_percentile():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 150, 1501):
        x = rng.integers(0, 10 ** 9, n) / 1000
        for p in (0, 50, 99, 100):
            np.testing.assert_allclose(
                PR.percentile(torch.from_numpy(x), p),
                float(jnp.percentile(jnp.asarray(x), p)), rtol=1e-12)


def _small(orig):
    """``orig`` with its request count cut to ``N``, however the caller
    passes it (positionally or as ``n=``)."""
    def small(*args, **kw):
        args = tuple(N if type(a) is int else a for a in args)
        if "n" in kw:
            kw["n"] = N
        return orig(*args, **kw)
    return small


@pytest.mark.parametrize("study", ["link_layer", "link_reliability"])
def test_quick_rows_equal_reference(study, monkeypatch):
    if study == "link_layer":
        ref_mod, port_mod = RL, PL
        names = ("run_generation", "run_efficiency_check")
        sweep = "run_ber_sweep"
    else:
        ref_mod, port_mod = RR, PR
        names = ("run_zero_ber_equivalence", "run_retrain_stall")
        sweep = "run_tail_sweep"
    for mod in (ref_mod, port_mod):
        for name in names:
            monkeypatch.setattr(mod, name, _small(getattr(mod, name)))
        orig = getattr(mod, sweep)
        monkeypatch.setattr(
            mod, sweep, lambda bers, n, _orig=orig, **kw:
            _orig(tuple(bers)[:3], N, **kw))
    ref = ref_mod.run(quick=True)
    log = StudyLog()
    got = port_mod.run(quick=True, device="cpu", log=log)
    assert [r.name for r in got] == [r.name for r in ref]
    assert [r.derived for r in got] == [r.derived for r in ref]
    # every gate flag (pass, monotone, matches, diverges, stalls) holds
    assert "=False" not in ";".join(r.derived for r in got)
    assert all(r.schedule is not None for r in log.runs)


def test_kernel_grid_equals_example():
    from repro.kernels.flit_pack.ops import flit_sweep
    from repro_torch.studies.link_explorer import (KERNEL_GRID_BERS,
                                                   KERNEL_GRID_PAYLOADS,
                                                   kernel_grid)

    ref = np.asarray(flit_sweep(np.asarray(KERNEL_GRID_PAYLOADS),
                                ["flit68", "flit256"], KERNEL_GRID_BERS,
                                impl="ref"))
    np.testing.assert_allclose(kernel_grid(device="cpu"), ref, rtol=1e-6)
