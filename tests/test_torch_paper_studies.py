"""PyTorch port, the paper-figure studies against the JAX reference's
benchmarks, row for row, at cut sizes on the CPU.

* `studies.validation`, `topology`, `routing`, `full_duplex` and `traces`:
  ``run(quick=True)`` on both sides, with the request counts and fabric
  scales cut the same way (each side's own ``measure`` / ``run_one`` /
  ``run_strategy`` / ``replay_topology`` wrapped by one monkeypatch), gives
  the same row names and the same ``derived`` strings, letter for letter.
  In the topology study the same small round budget is passed to both
  sides' `simulate` for the flooded ring, so its Fig. 10 rows end
  ``converged=False`` on both (the full-size ring's unconverged run is held
  by ``test_torch_round_bound.py::test_ring_paper_scale_exceeds_bound``).
* ``python -m repro_torch.studies.run --quick --only topology --device cpu``
  prints the rows it returns; the explorer's bandwidth sweep and routing
  demo print what ``examples/topology_explorer.py`` prints.
* Importing the studies pulls in neither JAX nor the reference package.

Tolerance: exact: every row name and ``derived`` string (the formatted
floats included) and every printed line.
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402  (x64 for the reference)
import benchmarks.bench_full_duplex as RFD  # noqa: E402
import benchmarks.bench_routing as RRO  # noqa: E402
import benchmarks.bench_topology as RTO  # noqa: E402
import benchmarks.bench_traces as RTR  # noqa: E402
import benchmarks.bench_validation as RVA  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.studies import full_duplex as PFD  # noqa: E402
from repro_torch.studies import routing as PRO  # noqa: E402
from repro_torch.studies import run as PRUN  # noqa: E402
from repro_torch.studies import topology as PTO  # noqa: E402
from repro_torch.studies import topology_explorer as PEX  # noqa: E402
from repro_torch.studies import traces as PTR  # noqa: E402
from repro_torch.studies import validation as PVA  # noqa: E402
from repro_torch.studies.common import StudyLog  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# cut sizes: few distinct table shapes, since the reference compiles each
N_MEASURE = 120      # validation requests per measurement
N_DUPLEX = 100       # full-duplex requests per run
MAX_PAIRS = 2        # fabric scale (requester/memory pairs)
N_PER_PAIR = 3       # topology requests per requester/memory pair
RING_ROUNDS = 2      # round budget of the flooded ring's fixpoint
PER_REQ = 20         # trace-replay requests per requester
N_SNOOP = 900        # the explorer's policy-sweep requests
N_HOST, N_NOISY = 20, 25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_lowering.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cut(monkeypatch, mod, name, fix):
    """Wrap ``mod.name`` so that ``fix(args, kw)`` cuts its sizes first."""
    orig = getattr(mod, name)

    def cut(*args, **kw):
        args, kw = fix(list(args), kw)
        return orig(*args, **kw)

    monkeypatch.setattr(mod, name, cut)


def _cut_validation(mod, monkeypatch):
    def fix(args, kw):
        if len(args) > 3:
            args[3] = N_MEASURE
        kw["n"] = N_MEASURE
        return args, kw
    _cut(monkeypatch, mod, "measure", fix)


def _cut_full_duplex(mod, monkeypatch):
    def fix(args, kw):
        args[3] = N_DUPLEX
        return args, kw
    _cut(monkeypatch, mod, "run_one", fix)


def _cut_topology(mod, monkeypatch, options):
    """Scales capped at ``MAX_PAIRS`` pairs, ``N_PER_PAIR`` requests a pair;
    the flooded ring's `simulate` gets ``RING_ROUNDS`` rounds."""
    flooded_ring = {"now": False}
    orig_sim = mod.simulate

    def simulate(hops, channels, issue_ps):
        opts = (options(max_rounds=RING_ROUNDS) if flooded_ring["now"]
                else None)
        return orig_sim(hops, channels, issue_ps, opts)

    def fix(args, kw):
        flooded_ring["now"] = (args[0] == "ring"
                               and args[3] == mod.FLOOD_IV_PS)
        args[1] = min(args[1], MAX_PAIRS)
        args[2] = N_PER_PAIR
        return args, kw
    monkeypatch.setattr(mod, "simulate", simulate)
    _cut(monkeypatch, mod, "run_one", fix)


def _cut_routing(mod, monkeypatch):
    def fix(args, kw):
        args[1:3] = [N_HOST, N_NOISY]
        return args, kw
    _cut(monkeypatch, mod, "run_strategy", fix)


def _cut_traces(mod, monkeypatch):
    def fix(args, kw):
        kw.update(n_pairs=MAX_PAIRS, per_req=PER_REQ)
        return args, kw
    _cut(monkeypatch, mod, "replay_topology", fix)


STUDIES = {
    "validation": (RVA, PVA, _cut_validation),
    "topology": (RTO, PTO, None),
    "routing": (RRO, PRO, _cut_routing),
    "full_duplex": (RFD, PFD, _cut_full_duplex),
    "traces": (RTR, PTR, _cut_traces),
}


@pytest.mark.parametrize("study", list(STUDIES))
def test_quick_rows_equal_reference(study, monkeypatch):
    ref_mod, port_mod, cut = STUDIES[study]
    if study == "topology":
        _cut_topology(ref_mod, monkeypatch, R.SimOptions)
        _cut_topology(port_mod, monkeypatch, P.SimOptions)
    else:
        cut(ref_mod, monkeypatch)
        cut(port_mod, monkeypatch)
    ref = ref_mod.run(quick=True)
    log = StudyLog()
    got = port_mod.run(quick=True, device="cpu", log=log)
    assert [r.name for r in got] == [r.name for r in ref]
    assert [r.derived for r in got] == [r.derived for r in ref]
    assert log.runs and all(r.schedule is not None for r in log.runs)
    assert not any(r.used_oracle for r in log.runs)
    assert {"lower", "simulate"} <= set(log.seconds)
    if study == "routing":
        assert "route" in log.seconds
    if study == "topology":
        unconverged = [r.name for r in got if "converged=False" in r.derived]
        assert unconverged == [f"fig10/ring/scale{2 * p}" for p in (2, 4, 8)]
        assert sum(not r.schedule.converged for r in log.runs) == 3
        assert all(r.schedule.rounds == RING_ROUNDS for r in log.runs
                   if not r.schedule.converged)
    if study in ("validation", "full_duplex", "routing"):
        # every gate flag the rows carry holds
        assert "=False" not in ";".join(r.derived for r in got)


def test_full_duplex_past_bound_equals_reference():
    """A half-duplex bus whose fixpoint needs 32 rounds against a bound of
    23: the reference's `simulate_auto` hands it to its oracle, the port's
    study runs the fixpoint on (``check="extend"``) with no oracle, and
    both return the same bandwidth, utility and efficiency."""
    args = (1.0, 64, "half", 1000)
    log = StudyLog()
    got = PFD.run_one(*args, device="cpu", log=log)
    assert got == RFD.run_one(*args)
    (run,) = log.runs
    assert not run.used_oracle and run.schedule.converged
    assert run.schedule.rounds == 32 > P.round_bound(run.hops)
    assert run.launches == 0  # the plain round on the CPU launches nothing


def test_study_log_nested_phases_count_for_themselves(monkeypatch):
    """A phase opened inside another counts its own seconds only; the
    outer phase keeps the rest, so the phases add up to the wall time."""
    from repro_torch.studies import common

    ticks = iter([0.0, 1.0, 3.0, 7.0])
    monkeypatch.setattr(common.time, "perf_counter", lambda: next(ticks))
    log = StudyLog()
    with log.phase("route"):
        with log.phase("simulate"):
            pass
    assert log.seconds == {"simulate": 2.0, "route": 5.0}


def test_run_cli_prints_the_rows(monkeypatch, capsys):
    _cut_topology(PTO, monkeypatch, P.SimOptions)
    rows = PRUN.main(["--quick", "--only", "topology", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(rows) == 25
    assert lines[0] == "name,us_per_call,derived"
    assert lines[1:-1] == [r.csv() for r in rows]
    assert lines[-1].startswith("total_wall_s,")
    assert [name for name, _ in PRUN.MODULES] == [
        "validation", "topology", "routing", "snoop_filter", "invblk",
        "full_duplex", "link_layer", "link_reliability", "coherence_fabric",
        "telemetry", "critical_path", "streaming", "traces",
        "coherence_modes"]
    with pytest.raises(SystemExit):
        PRUN.main(["--only", "no_such_study", "--device", "cpu"])


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def test_explorer_prints_what_the_example_prints(monkeypatch):
    """Each of the explorer's sweeps prints what the example's prints, with
    the fabric scale, the routing demo and the policy sweep's stream
    (8,000 requests, cut to ``N_SNOOP``) cut the same way on both sides."""
    spec = importlib.util.spec_from_file_location(
        "topology_explorer_example", REPO / "examples" / "topology_explorer.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    monkeypatch.setattr(ex, "SCALE", MAX_PAIRS)
    monkeypatch.setattr(PEX, "SCALE", MAX_PAIRS)
    _cut_routing(RRO, monkeypatch)
    _cut_routing(PRO, monkeypatch)
    monkeypatch.setattr(PEX, "run_strategy", PRO.run_strategy)
    for mod in (ex, PEX):
        def cut_stream(args, kw):
            args[0] = N_SNOOP
            return args, kw
        _cut(monkeypatch, mod, "make_skewed_stream", cut_stream)
    for name in ("bandwidth_sweep", "snoop_filter_sweep",
                 "adaptive_routing_demo"):
        assert _printed(getattr(PEX, name), "cpu") == \
            _printed(getattr(ex, name)), name


def test_studies_import_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch.studies.run, repro_torch.studies.validation\n"
        "import repro_torch.studies.topology, repro_torch.studies.routing\n"
        "import repro_torch.studies.full_duplex, repro_torch.studies.traces\n"
        "import repro_torch.studies.topology_explorer\n"
        "import repro_torch.core.traces, repro_torch.core.routing\n"
        "import repro_torch.core.vcs\n"
        "import repro_torch.studies.snoop_filter, repro_torch.studies.invblk\n"
        "import repro_torch.studies.coherence_fabric\n"
        "import repro_torch.studies.coherence_modes\n"
        "import repro_torch.core.coherence_traffic\n"
        "import repro_torch.kernels.sf_scan.ops\n"
        "import repro_torch.studies.telemetry, repro_torch.core.telemetry\n"
        "import repro_torch.studies.critical_path\n"
        "import repro_torch.studies.fabric_trace_viewer\n"
        "import repro_torch.core.critical_path, repro_torch.core.trace_export\n"
        "import repro_torch.core.streaming, repro_torch.studies.streaming\n"
        "import repro_torch.analysis, repro_torch.analysis.verify_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or\n"
        "             m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
