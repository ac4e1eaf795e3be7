"""PyTorch port, host lowering: every table equals the JAX reference's.

Topology graphs, link-layer lowering (flit modes, expected / stochastic
reliability with link-down markers, credit DLLPs) and `build_workload`
outputs are compared field by field, dtype and value, exactly.  Also holds
the port's import hygiene: ``repro_torch`` imports neither JAX nor the
``repro`` package, and its entry points refuse a CUDA device that is not
there.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402  (enables JAX x64 for the reference)
import repro_torch.core as P  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KINDS = ("chain", "tree", "ring", "spine_leaf", "fully_connected")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several worker
    processes side by side, and torch's default pool (one thread per core
    in each of them) oversubscribes the cores many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same(ref, port, what=""):
    """Exact equality of a reference array and a port tensor/array,
    including the dtype."""
    if ref is None or port is None:
        assert ref is None and port is None, what
        return
    a = np.asarray(ref)
    b = port.cpu().numpy() if isinstance(port, torch.Tensor) else \
        np.asarray(port)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _topo(mod, kind, n_pairs, flit=None):
    kw = dict(bw_MBps=64_000, fixed_ps=26_000)
    if kind == "spine_leaf":
        topo = mod.spine_leaf(n_pairs, n_spines=2, per_leaf=min(4, n_pairs),
                              **kw)
    elif kind == "single_bus":
        topo = mod.single_bus(n_mems=4, bw_MBps=128_000)
    else:
        topo = mod.TOPOLOGY_BUILDERS[kind](n_pairs, **kw)
    return mod.with_flit(topo, flit) if flit is not None else topo


def _specs(spec_cls, topo, n_per_pair, interval_ps=500, **kw):
    mems = [int(m) for m in topo.memories()]
    return [spec_cls(node=int(r), n_requests=n_per_pair * len(mems),
                     targets=mems, issue_interval_ps=interval_ps,
                     footprint_lines=4096 * len(mems), seed=i, **kw)
            for i, r in enumerate(topo.requesters())]


def _graph_tables_equal(gr, gp):
    for name in vars(gr):
        if name.startswith("chan_") or name in ("dist", "next_hop",
                                                "_service_chan"):
            _same(getattr(gr, name), getattr(gp, name), name)
    assert gr.n_channels == gp.n_channels
    assert gr._edge == gp._edge
    assert gr._alt_next == gp._alt_next
    n = gr.topo.n_nodes
    for s in range(n):
        for d in range(n):
            if gr.dist[s, d] < (1 << 48):
                assert gr.route(s, d) == gp.route(s, d)
                assert gr.n_route_alternatives(s, d) == \
                    gp.n_route_alternatives(s, d)


def _workloads_equal(wr, wp):
    for name in R.Hops._fields:
        _same(getattr(wr.hops, name), getattr(wp.hops, name), name)
    for name in R.Channels._fields:
        _same(getattr(wr.channels, name), getattr(wp.channels, name), name)
    for name in ("issue_ps", "payload_bytes", "measured", "requester",
                 "target", "is_write", "n_link_hops", "route_alt"):
        _same(getattr(wr, name), getattr(wp, name), name)
    assert wr.n_demand == wp.n_demand


def _both(kind, n_pairs, *, flit=None, override=None, n_per_pair=4,
          interval_ps=500, route_seed=17):
    """Build one fabric + workload in both packages.  ``flit`` (carried by
    every LinkSpec) and ``override`` (workload level) are FlitConfig kwargs:
    each side builds its own FlitConfig from them."""
    def cfg(mod, kw):
        return None if kw is None else mod.FlitConfig(**kw)

    tr = _topo(RT, kind, n_pairs, cfg(R, flit))
    tp = _topo(PT, kind, n_pairs, cfg(P, flit))
    gr, gp = tr.build(), tp.build()
    sr = _specs(R.RequesterSpec, tr, n_per_pair, interval_ps)
    sp = _specs(P.RequesterSpec, tp, n_per_pair, interval_ps)
    n_tx = sum(s.n_requests for s in sr)
    rc = np.random.default_rng(route_seed).integers(0, 1 << 20, n_tx)
    wr = R.build_workload(gr, sr, header_bytes=64, route_choice=rc,
                          flit=cfg(R, override))
    wp = P.build_workload(gp, sp, header_bytes=64, route_choice=rc,
                          flit=cfg(P, override), device="cpu")
    return gr, gp, wr, wp


# ---------------------------------------------------------------------------
# topology + workload tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pairs", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_paper_fabric_lowering_equal(kind, n_pairs):
    gr, gp, wr, wp = _both(kind, n_pairs)
    _graph_tables_equal(gr, gp)
    _workloads_equal(wr, wp)


@pytest.mark.parametrize("mode", ["none", "flit68", "flit256"])
@pytest.mark.parametrize("path", ["graph", "override"])
def test_flit_mode_lowering_equal(mode, path):
    kw = dict(mode=mode, ber=1e-7)
    if path == "graph":
        gr, gp, wr, wp = _both("tree", 2, flit=kw)
        _graph_tables_equal(gr, gp)
    else:
        _, _, wr, wp = _both("ring", 2, override=kw)
    _workloads_equal(wr, wp)


@pytest.mark.parametrize("reliability,ber", [("expected", 1e-6),
                                             ("stochastic", 3e-4)])
def test_reliability_lowering_equal(reliability, ber):
    kw = dict(ber=ber, reliability=reliability, rel_seed=7,
              retrain_threshold=2, retrain_ps=1_000_000)
    _, _, wr, wp = _both("tree", 2, flit=dict(mode="flit256", **kw),
                         n_per_pair=12, interval_ps=300)
    _workloads_equal(wr, wp)
    if reliability == "stochastic":
        mk = P.link_layer.retrain_marker_mask(
            wp.hops.channel.numpy(), wp.hops.nbytes.numpy(),
            wp.hops.valid.numpy(), wp.hops.retrain_after_ps.numpy())
        assert mk.sum() > 0, "no link-down markers: the case tests nothing"
        _same(R.devices.marker_column_map(wr.hops),
              P.devices.marker_column_map(wp.hops), "marker_column_map")


def test_bus_stochastic_override_equal():
    """The single-bus family of the reference's reliability suite, through
    the workload-level override path."""
    kw = dict(ber=1e-4, reliability="stochastic", rel_seed=7,
              retrain_threshold=2, retrain_ps=1_000_000)
    spec = dict(node=0, n_requests=60, targets=[2, 3, 4, 5], read_ratio=0.5,
                issue_interval_ps=300, payload_bytes=944, seed=3)
    wr = R.build_workload(_topo(RT, "single_bus", 0).build(),
                          [R.RequesterSpec(**spec)], warmup_frac=0.0,
                          flit=R.FlitConfig("flit256", **kw))
    wp = P.build_workload(_topo(PT, "single_bus", 0).build(),
                          [P.RequesterSpec(**spec)], warmup_frac=0.0,
                          flit=P.FlitConfig("flit256", **kw), device="cpu")
    _workloads_equal(wr, wp)


def test_credit_dllp_lowering_equal():
    kw = dict(mode="flit68", rx_credits=4, credit_dllp=True)
    _, _, wr, wp = _both("chain", 2, override=kw)
    assert wp.n_demand < wp.hops.channel.shape[0], "no DLLP rows emitted"
    _workloads_equal(wr, wp)


def test_marker_insert_strip_equal():
    kw = dict(ber=3e-4, reliability="stochastic", rel_seed=7,
              retrain_threshold=2, retrain_ps=1_000_000)
    _, gp, wr, wp = _both("ring", 2, flit=dict(mode="flit256", **kw),
                          n_per_pair=12, interval_ps=300)
    sr = R.link_layer.strip_retrain_markers(wr.hops)
    sp = P.link_layer.strip_retrain_markers(wp.hops)
    for name in R.Hops._fields:
        _same(getattr(sr, name), getattr(sp, name), name)
    back = P.link_layer.apply_retrain_markers(sp, gp.chan_pair)
    ref_back = R.link_layer.apply_retrain_markers(sr, gp.chan_pair)
    for name in R.Hops._fields:
        _same(getattr(ref_back, name), getattr(back, name), name)


def test_link_math_equal():
    for mode in ("none", "flit68", "flit256"):
        for ber in (0.0, 1e-9, 1e-5, 0.3):
            assert P.replay_overhead_ppm(ber, mode) == \
                R.replay_overhead_ppm(ber, mode)
            assert P.goodput_efficiency(mode, ber) == \
                R.goodput_efficiency(mode, ber)
        cfg = dict(mode=mode, rx_credits=8, credit_rtt_ps=50_000)
        assert P.credit_limited_MBps(128_000, P.FlitConfig(**cfg)) == \
            R.credit_limited_MBps(128_000, R.FlitConfig(**cfg))
    ref = R.link_layer.channel_rng(7, 3).integers(0, 1 << 30, 16)
    port = P.link_layer.channel_rng(7, 3).integers(0, 1 << 30, 16)
    assert np.array_equal(ref, port)


def test_convert_roundtrip_keeps_dtypes():
    _, _, wr, _ = _both("chain", 2)
    hops = P.hops_from_arrays(wr.hops, device="cpu")
    for name in R.Hops._fields:
        _same(getattr(wr.hops, name), getattr(hops, name), name)
    ch = P.channels_from_arrays(wr.channels, device="cpu")
    for name in R.Channels._fields:
        _same(getattr(wr.channels, name), getattr(ch, name), name)
    issue = P.issue_from_array(wr.issue_ps, device="cpu")
    _same(wr.issue_ps, issue)


# ---------------------------------------------------------------------------
# import hygiene and devices
# ---------------------------------------------------------------------------

def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch.core, repro_torch.kernels.serve_round.ops\n"
        "import repro_torch.kernels.link_contention.ops\n"
        "import repro_torch.kernels.flit_pack.ops\n"
        "import repro_torch.studies.link_layer\n"
        "import repro_torch.studies.link_reliability\n"
        "import repro_torch.studies.link_explorer\n"
        "import repro_torch.configs, repro_torch.configs.recurrentgemma_2b\n"
        "import repro_torch.kernels.rglru_scan.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.models.transformer, repro_torch.models.convert\n"
        "import repro_torch.runtime.server, repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or\n"
        "             m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    topo = _topo(PT, "chain", 2)
    graph = topo.build()
    specs = _specs(P.RequesterSpec, topo, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.build_workload(graph, specs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.make_channels(graph)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.issue_from_array(np.zeros(3, np.int64))


def test_port_kernel_packages_lint_clean():
    """The repo's kernel-signature lint holds for the port's kernel
    packages (kernel.py / ref.py / ops.py triple)."""
    from repro.analysis.jitlint import lint_paths

    assert lint_paths([REPO / "src" / "repro_torch"], repo_root=REPO) == []
