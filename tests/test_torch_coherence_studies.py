"""PyTorch port, the coherence studies against the JAX reference's
benchmarks, row for row, at cut sizes on the CPU.

* `studies.snoop_filter` (Fig. 14), `invblk` (Fig. 15), `coherence_fabric`
  and `coherence_modes`: ``run(quick=True)`` on both sides, with the stream
  lengths, footprints and background caps cut the same way (each side's own
  ``run_policy`` / ``run_len`` / ``run_divergence_sweep`` /
  ``run_fanout_sweep`` / ``run_trace_mode`` / ``run_mode`` wrapped by one
  monkeypatch, as `test_torch_paper_studies.py` cuts its studies), gives
  the same row names and the same ``derived`` strings, letter for letter.
  The coherence-fabric study also runs two of its four load levels (no
  background and the heaviest) and one of its two trace workloads.  At
  these cuts both sides' divergence and fan-out gates pass.
* The port's coherence-fabric run resolves each fixpoint iteration as one
  stacked schedule over the policies, and records its phases.

Tolerance: exact: every row name and ``derived`` string (the formatted
floats come from integer picoseconds).
"""

import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference)
import benchmarks.bench_coherence_fabric as RCF  # noqa: E402
import benchmarks.bench_coherence_modes as RCM  # noqa: E402
import benchmarks.bench_invblk as RIB  # noqa: E402
import benchmarks.bench_snoop_filter as RSF  # noqa: E402
from repro_torch.studies import coherence_fabric as PCF  # noqa: E402
from repro_torch.studies import coherence_modes as PCM  # noqa: E402
from repro_torch.studies import invblk as PIB  # noqa: E402
from repro_torch.studies import snoop_filter as PSF  # noqa: E402
from repro_torch.studies.common import StudyLog  # noqa: E402
from test_torch_paper_studies import _cut  # noqa: E402

# cut sizes (the reference compiles each configuration and table shape,
# and its coupled sweep compiles its vmapped fabric pass on every call)
N_SF, FOOT_SF = 600, 256        # Fig. 14 / 15 streams
N_DIV, FOOT_DIV = 120, 256      # the divergence sweep's stream
LOADS = (0.0, 0.9)              # its load levels: none and the heaviest
N_FANOUT, N_TRACE = 90, 90      # the fan-out sweep's and trace mode's
TRACES = ("xsbench",)           # trace mode's workloads
BG_CAP = 400                    # background rows per load level
N_PER_ACC = 60                  # coherence-modes requests per accelerator


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_lowering.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cut_stream_study(fn_name):
    def cut(mod, monkeypatch):
        def fix(args, kw):
            args[1:3] = [N_SF, FOOT_SF]
            return args, kw
        _cut(monkeypatch, mod, fn_name, fix)
    return cut


def _cut_coherence_fabric(mod, monkeypatch):
    monkeypatch.setattr(mod, "BG_ROW_CAP", BG_CAP)
    for name, cuts in (("run_divergence_sweep",
                        dict(n=N_DIV, footprint=FOOT_DIV, loads=LOADS)),
                       ("run_fanout_sweep", dict(n=N_FANOUT)),
                       ("run_trace_mode", dict(n=N_TRACE, names=TRACES))):
        def fix(args, kw, cuts=cuts):
            kw.update(cuts)
            return args, kw
        _cut(monkeypatch, mod, name, fix)


def _cut_coherence_modes(mod, monkeypatch):
    def fix(args, kw):
        kw["n_per"] = N_PER_ACC
        return args, kw
    _cut(monkeypatch, mod, "run_mode", fix)


STUDIES = {
    "snoop_filter": (RSF, PSF, _cut_stream_study("run_policy")),
    "invblk": (RIB, PIB, _cut_stream_study("run_len")),
    "coherence_fabric": (RCF, PCF, _cut_coherence_fabric),
    "coherence_modes": (RCM, PCM, _cut_coherence_modes),
}


@pytest.mark.parametrize("study", list(STUDIES))
def test_quick_rows_equal_reference(study, monkeypatch):
    ref_mod, port_mod, cut = STUDIES[study]
    cut(ref_mod, monkeypatch)
    cut(port_mod, monkeypatch)
    ref = ref_mod.run(quick=True)
    log = StudyLog()
    got = port_mod.run(quick=True, device="cpu", log=log)
    assert [r.name for r in got] == [r.name for r in ref]
    assert [r.derived for r in got] == [r.derived for r in ref]
    assert not any(r.used_oracle for r in log.runs)
    if study in ("snoop_filter", "invblk"):
        assert len(log.scans) == len(got) - (study == "snoop_filter")
        assert {"lower", "sf_scan"} <= set(log.seconds)
    elif study == "coherence_modes":
        assert len(log.runs) == 4 and {"lower", "verify",
                                       "simulate"} <= set(log.seconds)
    else:
        assert "=False" not in ";".join(r.derived for r in got)
        assert {"lower", "verify", "sf_scan", "simulate"} <= set(
            log.seconds)
        stacked = [r for r in log.runs if r.stacked]
        # every fixpoint iteration of the two loads and the trace is one
        # stacked pass over its policies, every member converged
        assert len(stacked) >= len(LOADS) + len(TRACES)
        assert all(all(r.schedule.converged) for r in stacked)
        assert {len(r.schedule.rounds) for r in stacked} == {4, 2}
        assert sum(not r.stacked for r in log.runs) == 6  # fan-out runs
