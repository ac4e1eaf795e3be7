"""PyTorch port on a CUDA card: the hand-written kernels against their plain
versions, the engine (one run and a stacked sweep), adaptive routing, a
Fig. 16/17 study, `simulate_coupled`, `telemetry.fabric_metrics` and the
critical-path replay (`critical_path.extract_backpointers`, with its paths,
blame and trace) run on the card against the same on the CPU, and the smoke
models of recurrentgemma-2b, mamba2-1.3b, qwen3-moe-30b-a3b, whisper-base
and phi-3-vision-4.2b (prefill and decode) on the card against the same
models on the CPU.

Every test here is marked ``cuda`` and skips without a card (the CUDA
kernel has no CPU mode).  The file imports neither JAX nor the reference
package, so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the engine's kernels exact (int64 picoseconds): the fused
serve round bit-equal to the plain round, on random sorted streams and on
the real rounds of runs, stacked sweeps and warm-carry runs; `rglru_scan`
bit-equal to `rglru_scan_blocked` at the kernel's chunk, and to its plain
version while one chunk covers the sequence, else ``1e-5`` (the chunk
carries round differently); `flash_attention` ``1e-4``
in float32 (the CUDA-core kernel) and 2 bf16 ulps in bf16 (the tensor-core
kernel; float32 sums in another order; see `bf16_within_ulps` for outputs
near zero); `ssd_chunk` ``atol 3e-5, rtol 3e-4`` (the reference suite's
kernel-vs-oracle tolerance) on its input family and on model-like inputs
alike, whose chunk cumsums reach -10^3 (the kernels and the plain version
take that cumsum in one order), plus one bf16 spacing for a bf16 output
(the tensor-core kernel); the models
on the card against the CPU ``5e-2``, the bf16 tolerance of the CPU tests
against the reference.  The gradients (the flash backward kernel, the scan's
reverse mode, a train step): the backward kernel against its plain version
on the same inputs (and, at the padded head dims 8 and 12, the plain
backward at the true D against the op's sliced gradients) within 2 bf16
spacings plus ``1e-3`` of the largest gradient plus ``1e-5`` (bf16
outputs, float32 sums in another order, float32 cancellation where a row
sees one key), the reverse scan bit-equal
to its blocked emulation and within ``1e-5`` of the largest value of its
plain walk, a smoke train step's loss and gradient leaves on the card
against the CPU within ``5e-2`` (the loss absolute, each leaf in relative
L2 norm); the SSD backward kernel against the plain backward in float64 on
the same bf16 values within ``chip_smoke.SSD_BWD_TOL``, each gradient in
relative L2 (dx in bf16; ddt and da_log carry float32 cancellation), the
tolerance `tests/test_torch_ssd_bwd.py` states.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd as FAB  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_ref)
from repro_torch.kernels.flit_pack import kernel as FK  # noqa: E402
from repro_torch.kernels.flit_pack.ref import flit_pack_ref  # noqa: E402
from repro_torch.kernels.link_contention import kernel as LK  # noqa: E402
from repro_torch.kernels.link_contention.ref import (  # noqa: E402
    random_stream, segmented_depart_ref)
from repro_torch.kernels.rglru_scan import kernel as RK  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.core.engine import (_flatten_members,  # noqa: E402
                                     _initial_arrive, _round_inputs)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    CHUNK, rglru_scan_blocked, rglru_scan_bwd_plain)
from repro_torch.kernels.serve_round import kernel as K  # noqa: E402
from repro_torch.kernels.serve_round import ops as SO  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel_bwd as SKB  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as SOPS  # noqa: E402
from repro_torch.kernels.ssd_chunk.ref import (  # noqa: E402
    ssd_chunk_bwd_plain, ssd_chunk_ref, ssd_final_state)
from repro_torch.kernels.serve_round.ref import (random_maps,  # noqa: E402
                                                 random_round,
                                                 serve_round_ref,
                                                 serve_scan_plain)
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [0, 3000])
def test_cuda_kernel_equals_plain(card, prefix):
    """Bit-equal at block edges, with and without a pass-through prefix
    longer than a block."""
    blk = K.block_items()
    for k in (1, 2, blk - 1, blk, blk + 1, 3 * blk + 5, 40_000):
        maps = [torch.from_numpy(m).to(card) for m in
                random_maps(k, k, prefix=min(prefix, k - 1))]
        got = K.serve_scan(*maps)
        torch.cuda.synchronize()
        assert torch.equal(got, serve_scan_plain(*maps)), k


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(n_chan=1),
                                dict(n_chan=2, serve=0.02, marker=0.01),
                                dict(markers_only=3), dict(tail=3000),
                                dict(n_chan=600, warm=True, offset=7 << 40)])
def test_cuda_fused_round_equals_plain(card, kw):
    """The fused round bit-equal to the plain round at block edges, on
    segments over many blocks, sparse serving items, marker-only segments,
    a padded tail and warm seeds."""
    blk = K.round_block_items()
    for k in (1, 2, 3, blk - 1, blk, blk + 1, 3 * blk + 5, 300 * blk + 7):
        args = [torch.from_numpy(x).to(card) for x in random_round(
            k, k, **dict(kw, tail=min(kw.get("tail", 0), k)))]
        before = K.LAUNCHES["serve_round"]
        got = SO.serve_round(*args)
        assert K.LAUNCHES["serve_round"] - before == 1
        want = serve_round_ref(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (k, kw)


def _cpu(wl):
    return (P.hops_from_arrays(wl.hops, device="cpu"),
            P.channels_from_arrays(wl.channels, device="cpu"),
            P.issue_from_array(wl.issue_ps, device="cpu"))


def _rounds_equal_plain(hops, channels, arrives, carry=None):
    """The fused round on the card against the plain round on the CPU, on
    the sorted operands of each of ``arrives``' rounds."""
    for arrive in arrives:
        _, args = _round_inputs(hops, channels, arrive, carry)
        got = SO.serve_round(*args)
        want = serve_round_ref(*(a.cpu() for a in args))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def _warm_carry(n_channels, device):
    rng = np.random.default_rng(5)
    return P.StreamCarry(
        depart_ps=torch.as_tensor(rng.integers(0, 6000, n_channels),
                                  device=device),
        last_dir=torch.as_tensor(rng.integers(-1, 2, n_channels),
                                 dtype=torch.int8, device=device),
        last_row=torch.as_tensor(rng.integers(-2, 3, n_channels),
                                 dtype=torch.int32, device=device),
        down_until_ps=torch.as_tensor(np.where(
            rng.random(n_channels) < .5, rng.integers(0, 9000, n_channels),
            0), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("fabric", ["tree", "half_duplex_rows"])
@pytest.mark.parametrize("warm", [False, True])
def test_cuda_simulate_equals_cpu(card, fabric, warm):
    """A run on the card equals the run on the CPU, launching the fused
    round once per round; its first and converged rounds equal the plain
    round.  ``half_duplex_rows`` turns its bus around and keeps DRAM rows;
    ``warm`` seeds every channel with a carried frontier."""
    if fabric == "tree":
        topo = P.tree(4, bw_MBps=64_000, fixed_ps=26_000)
        mems = [int(m) for m in topo.memories()]
        specs = [P.RequesterSpec(node=int(r), n_requests=40, targets=mems,
                                 issue_interval_ps=500, seed=i)
                 for i, r in enumerate(topo.requesters())]
    else:
        topo = P.single_bus(n_mems=4, duplex="half", turnaround_ps=3_000,
                            endpoint=P.EndpointSpec(
                                banks=2, row_hit_extra_ps=2_000,
                                row_miss_extra_ps=9_000))
        specs = [P.RequesterSpec(node=0, n_requests=400,
                                 targets=[2, 3, 4, 5], read_ratio=0.5,
                                 issue_interval_ps=300, seed=3)]
    wl = P.build_workload(topo.build(), specs, device=card)
    n_chan = wl.channels.bw_MBps.shape[0]
    carry = _warm_carry(n_chan, card) if warm else None
    before = K.LAUNCHES["serve_round"]
    gpu = P.simulate(wl.hops, wl.channels, wl.issue_ps, carry=carry)
    assert K.LAUNCHES["serve_round"] - before == gpu.rounds
    cpu = P.simulate(*_cpu(wl), carry=_warm_carry(n_chan, "cpu")
                     if warm else None)
    assert gpu.converged and gpu.rounds == cpu.rounds
    for f in ("start", "depart", "arrive", "complete"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    _rounds_equal_plain(wl.hops, wl.channels, [
        _initial_arrive(wl.hops, wl.channels, wl.issue_ps), gpu.arrive],
        carry)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(one_segment=True),
                                dict(singletons=True),
                                dict(lead_minus_one=2100)])
def test_cuda_depart_kernel_equals_plain(card, kw):
    """Bit-equal at tile edges, at 2**20 + 7 items (on one segment: the
    longest look-back), on more tiles than the card holds at once, with
    int64 and int32 channels, and over ten calls enqueued back to back on
    one stream (each call's workspace zeroed anew)."""
    blk = LK.block_items()
    resident = LK.blocks_per_sm() * torch.cuda.get_device_properties(
        card).multi_processor_count
    for k in (1, 2, blk - 1, blk, blk + 1, 3 * blk + 5, 40_000,
              (1 << 20) + 7, (resident + 3) * blk + 5):
        cols = [torch.from_numpy(x).to(card)
                for x in random_stream(k, k, **dict(
                    kw, lead_minus_one=min(kw.get("lead_minus_one", 0), k)))]
        want = segmented_depart_ref(*cols)
        for chan in (cols[0], cols[0].int()):
            got = LK.segmented_depart(chan, *cols[1:])
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, kw, chan.dtype)
    streams = [[torch.from_numpy(x).to(card) for x in random_stream(
        50_001, i, **(kw if i % 2 else dict(n_chan=300)))]
        for i in range(10)]
    wants = [segmented_depart_ref(*cols) for cols in streams]
    for chan_dtype in (torch.int64, torch.int32):
        torch.cuda.synchronize()
        gots = [LK.segmented_depart(cols[0].to(chan_dtype), *cols[1:])
                for cols in streams]
        torch.cuda.synchronize()
        for i, (got, want) in enumerate(zip(gots, wants)):
            assert torch.equal(got, want), (i, kw, chan_dtype)


@pytest.mark.cuda
def test_cuda_flit_kernel_equals_plain(card):
    """Bit-equal (wire and efficiency) around block and grid edges."""
    rng = np.random.default_rng(0)
    for k in (1, 255, 256, 257, 256 * 132 * 32 + 1):
        pay = rng.integers(0, 1_900_000_001, k)
        fsize = rng.choice([0, 68, 256], k)
        fpay = np.where(fsize == 68, 64, np.where(fsize == 256, 236, 0))
        ppm = rng.integers(0, 1_000_000_001, k)
        cols = [torch.from_numpy(x.astype(np.int32)).to(card)
                for x in (pay, fsize, fpay, ppm)]
        wire, eff = FK.flit_pack_kernel(*cols)
        w_ref, e_ref = flit_pack_ref(*cols)
        torch.cuda.synchronize()
        assert torch.equal(wire, w_ref) and torch.equal(eff, e_ref), k


@pytest.mark.cuda
def test_cuda_stacked_sweep_equals_cpu(card):
    """A BER sweep stacked on the card equals the same sweep on the CPU, and
    launches the serve scan once per round for all members."""
    topo = P.with_flit(P.single_bus(n_mems=4, bw_MBps=128_000),
                       P.FlitConfig("flit256"))
    spec = P.RequesterSpec(node=0, n_requests=300, targets=[2, 3, 4, 5],
                           read_ratio=0.5, issue_interval_ps=100,
                           payload_bytes=944, seed=11)
    out = {}
    for dev in (card, torch.device("cpu")):
        wl = P.build_workload(topo.build(), [spec], warmup_frac=0.0,
                              device=dev)
        link = wl.channels.flit_size > 0
        chans = [wl.channels._replace(replay_ppm=torch.where(
            link, torch.full_like(wl.channels.replay_ppm, p), 0))
            for p in (0, 1_000, 100_000)]
        tables = (P.stack_members([wl.hops] * 3), P.stack_members(chans),
                  torch.stack([wl.issue_ps] * 3))
        before = K.LAUNCHES["serve_round"]
        out[dev.type] = P.simulate_stacked(*tables)
        if dev.type == "cuda":
            assert K.LAUNCHES["serve_round"] - before == max(
                out["cuda"].rounds)
            gpu_tables = tables
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.rounds == cpu.rounds and all(gpu.converged)
    for f in ("start", "depart", "arrive", "complete"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    # the stacked converged round, all members in one sort
    fh, fc, _ = _flatten_members(*gpu_tables)
    _rounds_equal_plain(fh, fc, [gpu.arrive.reshape(
        -1, gpu.arrive.shape[-1])])


def _stochastic_bus(dev):
    rel = P.FlitConfig("flit256", ber=3e-4, reliability="stochastic",
                       rel_seed=7, retrain_threshold=2, retrain_ps=500_000)
    topo = P.with_flit(P.single_bus(n_mems=4, bw_MBps=128_000), rel)
    spec = P.RequesterSpec(node=0, n_requests=400, targets=[2, 3, 4, 5],
                           read_ratio=0.5, issue_interval_ps=300,
                           payload_bytes=944, seed=3)
    wl = P.build_workload(topo.build(), [spec], warmup_frac=0.0, device=dev)
    assert wl.hops.retrain_after_ps is not None
    return wl.hops, wl.channels, wl.issue_ps


def _join_tables(dev, seed=5, n=64, h=3, c=3):
    """Random hop table with a one-layer fork/join group."""
    rng = np.random.default_rng(seed)
    ch = P.Channels(*(torch.from_numpy(x).to(dev) for x in (
        rng.integers(10, 100, c).astype(np.int64) * 1000,
        np.where(rng.random(c) < .4, rng.integers(100, 4000, c),
                 0).astype(np.int64),
        np.zeros(c, np.int64), np.zeros(c, np.int64))))
    valid = rng.random((n, h)) < .85
    jid = np.full(n, -1, np.int32)
    jwait = np.full(n, -1, np.int32)
    jarity = np.zeros(n, np.int32)
    members = np.arange(n // 2)[rng.random(n // 2) < 0.6]
    jid[members] = 0
    jwait[n // 2] = 0
    jarity[n // 2] = members.size
    hops = P.Hops(*(None if x is None else torch.from_numpy(x).to(dev)
                    for x in (
        rng.integers(0, c, (n, h)).astype(np.int32),
        np.where(rng.random((n, h)) < 0.15, 0,
                 rng.integers(1, 400, (n, h))).astype(np.int64),
        rng.integers(0, 2, (n, h)).astype(np.int8),
        np.full((n, h), -1, np.int32),
        rng.integers(0, 2000, (n, h)).astype(np.int64), valid, valid,
        None, None, jid, jwait, jarity)))
    issue = torch.from_numpy(np.sort(rng.integers(0, 5000, n)).astype(
        np.int64)).to(dev)
    return hops, ch, issue


def _metrics_equal(got, want, what):
    """Every field of two `fabric_metrics` results: integers equal, float64
    equal bit for bit."""
    def same(g, w, name):
        g = g.cpu()
        assert g.dtype == w.dtype, name
        if w.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w), name

    for key, val in want.items():
        if isinstance(val, torch.Tensor):
            same(got[key], val, f"{what}.{key}")
        elif isinstance(val, tuple):
            for f in val._fields:
                same(getattr(got[key], f), getattr(val, f),
                     f"{what}.{key}.{f}")
        else:
            assert got[key] == val, f"{what}.{key}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stochastic_bus", "joins"])
def test_cuda_fabric_metrics_equals_cpu(card, case):
    """`fabric_metrics` on the card equals the CPU run field for field; the
    stochastic bus replays its retraining round through the fused serve
    round once, for the attribution and the blame together."""
    from repro_torch.core import telemetry

    build = _stochastic_bus if case == "stochastic_bus" else _join_tables
    out = {}
    for dev in (card, torch.device("cpu")):
        hops, ch, issue = build(dev)
        sched = P.simulate(hops, ch, issue)
        assert sched.converged
        before = K.LAUNCHES["serve_round"]
        out[dev.type] = telemetry.fabric_metrics(hops, ch, sched, issue)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert K.LAUNCHES["serve_round"] - before == (
                1 if case == "stochastic_bus" else 0)
    _metrics_equal(out["cuda"], out["cpu"], case)


@pytest.mark.cuda
def test_cuda_adaptive_routing_equals_cpu(card):
    """`route_and_simulate(strategy="adaptive")` on the card: the busy
    table comes back to the host before the float64 route choice, so every
    choice, the schedule and the channel stats equal the CPU run's."""
    topo = P.spine_leaf(4, n_spines=2, per_leaf=2)
    graph = topo.build()
    specs = [P.RequesterSpec(node=int(r), n_requests=60,
                             targets=[int(m) for m in topo.memories()],
                             issue_interval_ps=500, seed=i)
             for i, r in enumerate(topo.requesters())]
    out = {}
    for dev in (card, torch.device("cpu")):
        out[dev.type] = P.route_and_simulate(
            graph, specs, strategy="adaptive", seed=3, header_bytes=64,
            device=dev)
    (wg, sg, cg), (wc, sc, cc) = out["cuda"], out["cpu"]
    assert np.array_equal(wg.route_alt, wc.route_alt)
    assert len(set(wg.route_alt.tolist())) > 1
    assert sg.rounds == sc.rounds and sg.converged
    for f in ("start", "depart", "arrive", "complete"):
        assert torch.equal(getattr(sg, f).cpu(), getattr(sc, f)), f
    for key in cc:
        assert torch.equal(cg[key].cpu(), cc[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("duplex", ["full", "half"])
def test_cuda_full_duplex_run_equals_cpu(card, duplex):
    """`studies.full_duplex.run_one` (Fig. 16/17) on the card returns what
    the CPU run returns."""
    from repro_torch.studies import full_duplex

    for rr, header in ((1.0, 0), (0.5, 32)):
        assert full_duplex.run_one(rr, header, duplex, 1000,
                                   device=card) == \
            full_duplex.run_one(rr, header, duplex, 1000, device="cpu")


@pytest.mark.cuda
def test_cuda_rglru_kernel_equals_plain(card):
    """Around the chunk and tile edges and the block width, with a near 1 as
    the model draws it, and the smoke model's short prefills (D 64):
    bit-equal to the CPU emulation of its chunk carries
    everywhere, and to the plain version while one chunk covers the
    sequence."""
    gen = torch.Generator(device=card).manual_seed(0)
    ch = RK.chunk()
    assert ch == CHUNK
    tile = RK.tile()
    for b, s, d in [(1, 1, 1), (3, ch - 1, 255), (1, ch, 256),
                    (2, ch + 1, 257), (1, 5 * ch + 3, 31), (1, 300, 2560),
                    (2, tile - 1, 33), (1, tile + 1, 64),
                    (1, 3 * tile + ch + 5, 2560), (1, 4, 64), (1, 11, 64)]:
        r = torch.rand(b, s, d, generator=gen, device=card)
        a = torch.exp(-8.0 * r * torch.rand(d, generator=gen, device=card)
                      * 0.1)
        x = torch.randn(b, s, d, generator=gen, device=card)
        bb = torch.sqrt(1 - a * a) * x
        got = RK.rglru_scan_kernel(a, bb)
        want = rglru_scan_ref(a, bb)
        torch.cuda.synchronize()
        assert torch.equal(got, rglru_scan_blocked(a, bb, ch)), (b, s, d)
        if s <= ch:
            assert torch.equal(got, want), (b, s, d)
        else:
            assert torch.allclose(got, want, atol=1e-5, rtol=1e-5), (b, s, d)


def bf16_within_ulps(got, want, n):
    """|got - want| <= n bf16 spacings at the larger magnitude of the two,
    that magnitude taken as at least 2**-6 (spacing 2**-13, about the
    float32 comparison's 1e-4): an output near zero is a difference of
    terms of order one, and float32 sums of those taken in another order
    differ by about 1e-6 of them, many spacings of a value near zero."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -6)
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((g - w).abs() <= n * spacing).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel_equals_plain(card, dtype):
    """Around the 64-row and 64-key tile edges: GQA, MQA, a window,
    non-causal, head dims 16 to 256, fewer queries than keys."""
    gen = torch.Generator(device=card).manual_seed(1)
    for b, kv, g, s, t, d, causal, window in [
            (1, 1, 1, 1, 1, 16, True, 0), (2, 2, 3, 63, 63, 64, True, 0),
            (1, 1, 10, 65, 65, 256, True, 32),
            (1, 2, 1, 130, 130, 128, False, 0),
            (1, 1, 4, 200, 200, 32, True, 64),
            (1, 1, 2, 129, 129, 64, False, 50),
            (1, 1, 3, 65, 200, 64, True, 0), (1, 2, 2, 70, 131, 32, False, 40)]:
        q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
                   for shape in ((b, s, kv * g, d), (b, t, kv, d),
                                 (b, t, kv, d)))
        got = FA.flash_attention_kernel(q, k, v, causal=causal,
                                        window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), (s, d)
        else:
            assert bf16_within_ulps(got, want, 2), (s, d)


def launched(launches, call):
    """The launch counts ``call()`` added, by kernel."""
    before = dict(launches)
    call()
    return {name: launches[name] - before[name] for name in launches}


@pytest.mark.cuda
def test_cuda_flash_tc_kernel_equals_plain(card):
    """The tensor-core kernel (bf16, D a multiple of 16): S around the
    128-row and 64-key tiles, S < T, windows, non-causal, the model's shape
    (S 4,096, H 10, KV 1, D 256, window 2,048) and the smoke model's (H 4,
    KV 1, D 16, window 32, S 11 and 64); each call raises the
    tensor-core counter and not the other.  Float32, and bf16 with D not a
    multiple of 16, take the CUDA-core kernel, held to the same tolerances
    (1e-4 in float32, 2 ulps in bf16)."""
    gen = torch.Generator(device=card).manual_seed(3)

    def qkv(b, kv, g, s, t, d, dtype):
        return [torch.randn(shape, generator=gen, device=card).to(dtype)
                for shape in ((b, s, kv * g, d), (b, t, kv, d),
                              (b, t, kv, d))]

    for b, kv, g, s, t, d, causal, window in [
            (1, 1, 1, 1, 1, 16, True, 0), (1, 1, 2, 127, 127, 48, True, 0),
            (2, 2, 3, 129, 129, 64, True, 40),
            (1, 1, 4, 300, 301, 128, False, 0),
            (1, 1, 2, 200, 333, 80, False, 70),
            (1, 1, 10, 4096, 4096, 256, True, 2048),
            (1, 1, 4, 11, 11, 16, True, 32), (1, 1, 4, 64, 64, 16, True, 32)]:
        q, k, v = qkv(b, kv, g, s, t, d, torch.bfloat16)
        out = []
        counts = launched(FA.LAUNCHES, lambda: out.append(
            FA.flash_attention_kernel(q, k, v, causal=causal,
                                      window=window)))
        assert counts == {"flash_attention": 0, "flash_attention_tc": 1}
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert bf16_within_ulps(out[0], want, 2), (s, t, d, window)
    for dtype, d, s, t, window in (
            (torch.float32, 64, 70, 70, 0), (torch.bfloat16, 24, 70, 70, 0),
            (torch.bfloat16, 24, 129, 200, 40),
            (torch.bfloat16, 200, 300, 300, 128)):
        q, k, v = qkv(1, 1, 2, s, t, d, dtype)
        out = []
        counts = launched(FA.LAUNCHES, lambda: out.append(
            FA.flash_attention_kernel(q, k, v, window=window)))
        assert counts == {"flash_attention": 1, "flash_attention_tc": 0}
        want = flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            assert torch.allclose(out[0], want, atol=1e-4, rtol=1e-4), d
        else:
            assert bf16_within_ulps(out[0], want, 2), (s, t, d, window)


@pytest.mark.cuda
def test_cuda_model_equals_cpu(card):
    """recurrentgemma-2b's smoke model: prefill (prompt longer than the
    window) and three decode steps on the card against the CPU; the card's
    prefill launches each kernel once per layer of its kind."""
    cfg = get_smoke_config("recurrentgemma-2b")
    cpu = TF.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = TF.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu.to(card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 48)))
    kinds = [k.split("_", 1)[1] for k, _ in gpu.keys]
    before = dict(FA.LAUNCHES, rglru_scan=RK.LAUNCHES["rglru_scan"])
    gl, gc = TF.prefill(gpu, toks.to(card), 64)
    # bf16 attention takes the tensor-core kernel, never the CUDA-core one
    assert FA.LAUNCHES["flash_attention_tc"] - before[
        "flash_attention_tc"] == kinds.count("attn_local")
    assert FA.LAUNCHES["flash_attention"] == before["flash_attention"]
    assert RK.LAUNCHES["rglru_scan"] - before["rglru_scan"] == kinds.count(
        "rglru")
    cl, cc = TF.prefill(cpu, toks, 64)
    assert torch.allclose(gl.cpu().float(), cl.float(), atol=5e-2,
                          rtol=5e-2)
    for i in range(3):
        tok = toks[:, i:i + 1]
        pos = torch.full((2, 1), 48 + i, dtype=torch.int32)
        gl, gc = TF.decode_step(gpu, gc, tok.to(card), pos.to(card))
        cl, cc = TF.decode_step(cpu, cc, tok, pos)
        assert torch.allclose(gl.cpu().float(), cl.float(), atol=5e-2,
                              rtol=5e-2), i


def ssd_inputs(gen, card, b, s, h, p, n, model_like):
    """(x, dt, a_log, b, c) float32 on the card: the reference suite's
    family (dt in [0.001, 0.1], A in [1, 8]) or the model's (dt a softplus
    of a normal draw, A = linspace(1, 16))."""
    x = torch.randn(b, s, h, p, generator=gen, device=card)
    if model_like:
        dt = torch.nn.functional.softplus(
            torch.randn(b, s, h, generator=gen, device=card))
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=card))
    else:
        dt = 0.001 + 0.099 * torch.rand(b, s, h, generator=gen, device=card)
        a_log = torch.log(1 + 7 * torch.rand(h, generator=gen, device=card))
    bm, cm = (torch.randn(b, s, n, generator=gen, device=card)
              for _ in range(2))
    return x, dt, a_log, bm, cm


@pytest.mark.cuda
def test_cuda_ssd_kernel_equals_plain(card):
    """Around the 128-step chunk edge, ragged tails, one and two batch rows,
    the model's head shape and the smoke config's, float32 and bf16, both
    input families; y and the final state.  S 421 puts the tensor-core
    kernel's segment boundary one chunk before the ragged tail; S 16,384 is
    the server's longest prompt (128 chunks)."""
    gen = torch.Generator(device=card).manual_seed(2)
    for b, s, h, p, n in [(1, 1, 64, 64, 128), (2, 5, 64, 64, 128),
                          (1, 127, 64, 64, 128), (2, 128, 4, 16, 16),
                          (1, 129, 64, 64, 128), (2, 300, 3, 24, 40),
                          (1, 421, 64, 64, 128), (1, 1000, 64, 64, 128),
                          (1, 16_384, 64, 64, 128)]:
        for model_like in (False, True):
            atol, rtol = 3e-5, 3e-4
            args = ssd_inputs(gen, card, b, s, h, p, n, model_like)
            for dtype in (torch.float32, torch.bfloat16):
                x, dt, a_log, bm, cm = (
                    t.to(dtype) if i in (0, 3, 4) else t
                    for i, t in enumerate(args))
                y, state = SK.ssd_chunk_kernel(x, dt, a_log, bm, cm)
                want = ssd_chunk_ref(x, dt, a_log, bm, cm)
                want_state = ssd_final_state(x, dt, a_log, bm)
                torch.cuda.synchronize()
                case = (b, s, h, p, n, model_like, dtype)
                assert y.dtype == dtype, case
                extra = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
                assert torch.allclose(y.float(), want.float(), atol=atol,
                                      rtol=rtol + extra), case
                assert torch.allclose(state, want_state, atol=atol,
                                      rtol=rtol), case


@pytest.mark.cuda
def test_cuda_ssd_tc_kernel_equals_plain(card):
    """The tensor-core kernel (bf16, P and N multiples of 8): S around the
    128-step chunk, P and N padded inside (24, 40, 16), head counts that do
    not fill the card (H 3, 4, 12: many segments a head), the model's shape
    at S 4,096 and 16,384, S 421 (two segments of two chunks: the boundary
    one chunk before the ragged tail) and S 933 (also at 1, 2, 3 and 7
    segments; at 7 the last boundary is one chunk before the ragged tail),
    B * H of 66,000
    blocks, both input families;
    each call raises the tensor-core counter and not the other, and a
    second call on the same inputs gives the same bits.  Float32, and bf16
    with P not a multiple of 8, take the CUDA-core kernel, held to the same
    tolerances."""
    gen = torch.Generator(device=card).manual_seed(4)
    atol, rtol = 3e-5, 3e-4
    cases = [(1, 1, 64, 64, 128, None), (2, 129, 12, 64, 128, None),
             (1, 300, 3, 24, 40, None), (2, 257, 4, 16, 16, None),
             (1, 4096, 64, 64, 128, None), (1, 16_384, 64, 64, 128, None),
             (1, 421, 64, 64, 128, None), (1, 933, 64, 64, 128, None)]
    cases += [(1, 933, 64, 64, 128, seg) for seg in (1, 2, 3, 7)]
    # more blocks than a grid's second dimension takes (B * H > 65,535)
    cases += [(1100, 1, 60, 8, 16, None)]
    for b, s, h, p, n, segments in cases:
        for model_like in (False, True):
            x, dt, a_log, bm, cm = (
                t.to(torch.bfloat16) if i in (0, 3, 4) else t
                for i, t in enumerate(ssd_inputs(gen, card, b, s, h, p, n,
                                                 model_like)))
            out = []
            counts = launched(SK.LAUNCHES, lambda: out.append(
                SK.ssd_chunk_kernel(x, dt, a_log, bm, cm,
                                    segments=segments)))
            assert counts == {"ssd_chunk": 0, "ssd_chunk_tc": 1}
            y, state = out[0]
            want = ssd_chunk_ref(x, dt, a_log, bm, cm)
            want_state = ssd_final_state(x, dt, a_log, bm)
            y2, state2 = SK.ssd_chunk_kernel(x, dt, a_log, bm, cm,
                                             segments=segments)
            torch.cuda.synchronize()
            case = (b, s, h, p, n, segments, model_like)
            assert y.dtype == torch.bfloat16, case
            assert torch.allclose(y.float(), want.float(), atol=atol,
                                  rtol=rtol + 2.0 ** -7), case
            assert torch.allclose(state, want_state, atol=atol,
                                  rtol=rtol), case
            assert torch.equal(y2, y) and torch.equal(state2, state), case
    for dtype, p in ((torch.float32, 64), (torch.bfloat16, 20)):
        for model_like in (False, True):
            args = [t.to(dtype) if i in (0, 3, 4) else t
                    for i, t in enumerate(ssd_inputs(gen, card, 1, 200, 2, p,
                                                     16, model_like))]
            out = []
            counts = launched(SK.LAUNCHES, lambda: out.append(
                SK.ssd_chunk_kernel(*args)))
            assert counts == {"ssd_chunk": 1, "ssd_chunk_tc": 0}
            y, state = out[0]
            want = ssd_chunk_ref(*args)
            want_state = ssd_final_state(*args[:4])
            torch.cuda.synchronize()
            case = (p, dtype, model_like)
            assert y.dtype == dtype, case
            extra = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
            assert torch.allclose(y.float(), want.float(), atol=atol,
                                  rtol=rtol + extra), case
            assert torch.allclose(state, want_state, atol=atol,
                                  rtol=rtol), case


def ssd_bwd_tol():
    """chip_smoke.py's `SSD_BWD_TOL` (the SSD backward against the plain
    backward in float64 on the same bf16 values, each gradient in relative
    L2; tests/test_torch_ssd_bwd.py states the same numbers)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_tol", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SSD_BWD_TOL


@pytest.mark.cuda
def test_cuda_ssd_bwd_kernel_equals_plain(card):
    """The SSD backward kernel (bf16, P and N multiples of 8) against the
    plain backward: one step, a ragged single chunk, two chunks and a step,
    a segment boundary before a ragged tail, mamba2-1.3b's head shape at S
    4,096; 1, 2 and 3 segments of the adjoint walk; the default group of
    heads of the gradient launch and groups of 2 (the last of 3 heads
    ragged); with and without dstate; both input families.  Each call
    counts once and a second call gives the same bits;
    the forward's chunk states leave y and the final state bit-equal to
    the served call.  Under grad, float32 on the card is refused."""
    gen = torch.Generator(device=card).manual_seed(6)
    tolerance = ssd_bwd_tol()
    for b, s, h, p, n in [(2, 1, 4, 16, 16), (2, 100, 3, 24, 40),
                          (2, 257, 4, 16, 16), (1, 421, 4, 64, 128),
                          (1, 4096, 8, 64, 128)]:
        for model_like in (False, True):
            x, dt, a_log, bm, cm = (
                t.to(torch.bfloat16) if i in (0, 3, 4) else t
                for i, t in enumerate(ssd_inputs(gen, card, b, s, h, p, n,
                                                 model_like)))
            dy = torch.randn(b, s, h, p, generator=gen,
                             device=card).to(torch.bfloat16)
            for seed in (torch.randn(b, h, p, n, generator=gen, device=card),
                         None):
                y, state, states = SK.ssd_chunk_kernel(
                    x, dt, a_log, bm, cm, return_states=True)
                y0, state0 = SK.ssd_chunk_kernel(x, dt, a_log, bm, cm)
                assert torch.equal(y, y0) and torch.equal(state, state0)
                want = ssd_chunk_bwd_plain(*(
                    t.double() for t in (x, dt, a_log, bm, cm, dy)),
                    None if seed is None else seed.double())
                for seg, grp in [(1, None), (2, None), (3, None), (2, 2)]:
                    before = SKB.BWD_LAUNCHES["ssd_chunk_bwd"]
                    got = SKB.ssd_chunk_bwd_kernel(x, dt, a_log, bm, cm, dy,
                                                   seed, states, segments=seg,
                                                   group=grp)
                    again = SKB.ssd_chunk_bwd_kernel(
                        x, dt, a_log, bm, cm, dy, seed, states, segments=seg,
                        group=grp)
                    assert SKB.BWD_LAUNCHES["ssd_chunk_bwd"] == before + 2
                    torch.cuda.synchronize()
                    case = (b, s, h, p, n, model_like, seed is None, seg, grp)
                    assert all(torch.equal(u, v) for u, v in zip(got, again))
                    for (name, tol), g, w in zip(tolerance.items(), got,
                                                 want):
                        diff = float((g.double() - w).norm())
                        assert diff <= tol * max(float(w.norm()), 1e-30) \
                            or diff == 0.0, (case, name)
    x = torch.randn(1, 8, 2, 16, device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="gradient on the card"):
        SOPS.ssd_chunk(x, torch.rand(1, 8, 2, device=card),
                       torch.zeros(2, device=card),
                       torch.randn(1, 8, 16, device=card),
                       torch.randn(1, 8, 16, device=card))


@pytest.mark.cuda
def test_cuda_ssd_instances_report_their_chunks_and_compile_clean(
        card, tmp_path):
    """Every SSD library reports the chunk lengths `kernel.CHUNKS` at load,
    and ptxas builds every instance of the three sources (a template per
    chunk length) with no spill and no serialized wgmma (notes C7511,
    C7512, C7515, C7520)."""
    import re
    import subprocess

    from repro_torch.kernels import _build

    for lib, prefix in ((SK._lib(), "ssd_chunk"), (SK._lib_tc(),
                                                     "ssd_chunk_tc"),
                        (SKB._lib_bwd(), "ssd_chunk_bwd")):
        assert SK.built_chunks(lib, prefix) == SK.CHUNKS
    for src in (SK._SOURCE, SK._SOURCE_TC, SKB._SOURCE):
        done = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(tmp_path / f"{src.stem}.so"), str(src)],
            capture_output=True, text=True, check=True)
        log = done.stdout + done.stderr
        assert not re.search(r"\(C75(11|12|15|20)\)", log), src.name
        seen = set()
        for block in log.split("Compiling entry function")[1:]:
            m = re.search(r"ILi(\d+)E", block.splitlines()[0])
            if m:
                seen.add(int(m[1]))
                assert " 0 bytes spill stores, 0 bytes spill loads" in block, (
                    src.name, block.splitlines()[0])
        assert seen == set(SK.CHUNKS), src.name


@pytest.mark.cuda
@pytest.mark.parametrize("q", [32, 64, 256])
def test_cuda_ssd_kernels_at_other_chunks_equal_plain(card, q):
    """At chunk length q: the tensor-core forward (and its chunk states'
    instance, bit-equal to the served one), the CUDA-core forward and the
    backward against their plain versions at that length on a sequence
    shorter than a chunk, one chunk and two chunks with a ragged tail, the
    smoke and full widths, 1 and 2 segments; ``SSD_TOL`` for the forward,
    chip_smoke's ``SSD_BWD_TOL`` for the backward; two calls bit-equal."""
    gen = torch.Generator(device=card).manual_seed(q)
    atol, rtol = 3e-5, 3e-4
    tolerance = ssd_bwd_tol()
    for b, s, h, p, n in [(2, q - 3, 4, 16, 16), (1, q, 8, 64, 128),
                          (2, 2 * q + 5, 4, 64, 128)]:
        args = ssd_inputs(gen, card, b, s, h, p, n, True)
        f32 = SK.ssd_chunk_kernel(*args, chunk=q)
        torch.cuda.synchronize()
        assert torch.allclose(f32[0], ssd_chunk_ref(*args, chunk=q),
                              atol=atol, rtol=rtol), (q, s)
        x, dt, a_log, bm, cm = (t.to(torch.bfloat16) if i in (0, 3, 4) else t
                                for i, t in enumerate(args))
        dy = torch.randn(b, s, h, p, generator=gen,
                         device=card).to(torch.bfloat16)
        dstate = torch.randn(b, h, p, n, generator=gen, device=card)
        want = ssd_chunk_ref(x, dt, a_log, bm, cm, chunk=q).float()
        want_state = ssd_final_state(x, dt, a_log, bm, chunk=q)
        want_bwd = ssd_chunk_bwd_plain(*(
            t.double() for t in (x, dt, a_log, bm, cm, dy)),
            dstate.double(), chunk=q)
        for seg in (1, 2):
            y, state = SK.ssd_chunk_kernel(x, dt, a_log, bm, cm, chunk=q,
                                           segments=seg)
            y2, state2, states = SK.ssd_chunk_kernel(
                x, dt, a_log, bm, cm, chunk=q, segments=seg,
                return_states=True)
            got = SKB.ssd_chunk_bwd_kernel(x, dt, a_log, bm, cm, dy, dstate,
                                           states, chunk=q, segments=seg)
            again = SKB.ssd_chunk_bwd_kernel(x, dt, a_log, bm, cm, dy,
                                             dstate, states, chunk=q,
                                             segments=seg)
            torch.cuda.synchronize()
            case = (q, b, s, h, p, n, seg)
            assert torch.equal(y, y2) and torch.equal(state, state2), case
            assert torch.allclose(y.float(), want, atol=atol,
                                  rtol=rtol + 2.0 ** -7), case
            assert torch.allclose(state, want_state, atol=atol,
                                  rtol=rtol), case
            assert all(torch.equal(u, v) for u, v in zip(got, again)), case
            for (name, tol), g, w in zip(tolerance.items(), got, want_bwd):
                diff = float((g.double() - w).norm())
                assert diff <= tol * max(float(w.norm()), 1e-30), (case,
                                                                   name)


@pytest.mark.cuda
def test_cuda_mamba_model_equals_cpu(card):
    """mamba2-1.3b's smoke model: prefill (two chunks, a ragged tail) and
    three decode steps on the card against the CPU; the card's prefill
    launches the SSD kernel once per layer."""
    cfg = get_smoke_config("mamba2-1.3b")
    cpu = TF.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = TF.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu.to(card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 150)))
    before = dict(SK.LAUNCHES)
    gl, gc = TF.prefill(gpu, toks.to(card), 256)
    # bf16 x, b and c take the tensor-core kernel, never the CUDA-core one
    assert SK.LAUNCHES["ssd_chunk_tc"] - before["ssd_chunk_tc"] == \
        cfg.n_layers
    assert SK.LAUNCHES["ssd_chunk"] == before["ssd_chunk"]
    cl, cc = TF.prefill(cpu, toks, 256)
    assert torch.allclose(gl.cpu().float(), cl.float(), atol=5e-2,
                          rtol=5e-2)
    for i in range(3):
        tok = toks[:, i:i + 1]
        pos = torch.full((2, 1), 150 + i, dtype=torch.int32)
        gl, gc = TF.decode_step(gpu, gc, tok.to(card), pos.to(card))
        cl, cc = TF.decode_step(cpu, cc, tok, pos)
        assert torch.allclose(gl.cpu().float(), cl.float(), atol=5e-2,
                              rtol=5e-2), i


def _sf_outputs(res, ev, state):
    return [*res, *ev, *state]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lfi", "blp_bus", "global_state", "fifo",
                                  "mru", "r4_conflicts"])
def test_cuda_sf_scan_equals_cpu(card, case):
    """The snoop-filter scan kernel bit-equal to the plain version on the
    CPU: a policy with fabric latencies and a chunked run threading the
    state, InvBlk 4 on a finite bus, a footprint whose state does not fit
    in shared memory (the kernel then works in device memory, its maps in
    a workspace), fifo and mru, and 4 requesters with writes (conflicts on
    hits)."""
    from repro_torch.core import snoop_filter as PS
    from repro_torch.kernels.sf_scan import kernel as SFK

    foot = 65_536 if case == "global_state" else 512
    n_req = 4 if case == "r4_conflicts" else 2
    policy = {"lfi": "lfi", "fifo": "fifo", "mru": "mru",
              "r4_conflicts": "fifo"}.get(case, "blp")
    cfg = PS.SFConfig(capacity=64, footprint_lines=foot, policy=policy,
                      invblk_max=4 if policy == "blp" else 1,
                      bus_MBps=12_000 if case == "blp_bus" else 0)
    assert (SFK.smem_bytes(PS.scan_config(cfg, PS.CacheConfig(64), n_req))
            > SFK._lib().sf_scan_max_smem(0)) == (case == "global_state")
    stream = (PS.make_sequential_stream(900, foot, n_requesters=2,
                                        write_ratio=0.5, seed=1,
                                        device="cpu")
              if case == "blp_bus" else
              PS.make_skewed_stream(900, foot, write_ratio=0.3,
                                    n_requesters=n_req, seed=2,
                                    device="cpu"))
    fab = torch.from_numpy(np.random.default_rng(0).integers(
        50_000, 500_000, 900)) if case == "lfi" else None
    kw = dict(n_requesters=n_req, return_events=True, return_state=True)
    want = PS.simulate_sf(*stream, cfg, PS.CacheConfig(64),
                          fabric_lat_ps=fab, **kw)
    before = SFK.LAUNCHES["sf_scan"]
    got = PS.simulate_sf(*(x.to(card) for x in stream), cfg,
                         PS.CacheConfig(64), fabric_lat_ps=None if fab is None
                         else fab.to(card), **kw)
    assert SFK.LAUNCHES["sf_scan"] - before == 1
    for g, w in zip(_sf_outputs(*got), _sf_outputs(*want)):
        assert torch.equal(g.cpu(), w)
    if case == "r4_conflicts":
        ev = want[1]
        assert bool((ev.conflict & ev.cache_hit).any())
    if case == "lfi":
        state = None
        for lo in range(0, 900, 300):
            part = [x[lo:lo + 300].to(card) for x in stream]
            res, ev, state = PS.simulate_sf(
                *part, cfg, PS.CacheConfig(64), init_state=state,
                fabric_lat_ps=fab[lo:lo + 300].to(card), **kw)
            assert torch.equal(res.latency_ps.cpu(),
                               want[0].latency_ps[lo:lo + 300])
        for g, w in zip(state, want[2]):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [False, True])
@pytest.mark.parametrize("fanout", ["chain", "concurrent"])
def test_cuda_simulate_coupled_equals_cpu(card, fanout, damping):
    """`simulate_coupled` with background demand on the card (its scans
    through `sf_scan`, its fabric passes through the fused serve round)
    equal to the same run on the CPU, iteration for iteration, and no pass
    answered by the host oracle."""
    from repro_torch.core import snoop_filter as PS
    from repro_torch.core.coherence_traffic import simulate_coupled
    from repro_torch.studies import coherence_fabric as CF

    graph, spec, bg_nodes = CF.build_coherence_fabric(2)
    cfg = PS.SFConfig(capacity=51, policy="lifo", footprint_lines=512)
    cache = PS.CacheConfig(capacity=51)
    stream = PS.make_skewed_stream(400, 512, write_ratio=0.2, n_requesters=2,
                                   seed=7, device="cpu")
    span = int(PS.simulate_sf(*stream, cfg, cache,
                              n_requesters=2).total_time_ps)
    kw = dict(n_requesters=2, options=P.SimOptions(damping=damping),
              max_iters=12 if damping else 6, tol_ps=2_000 if damping else 0,
              fanout=fanout)
    runs = [simulate_coupled(
        *(x.to(dev) for x in stream), cfg, cache, graph, spec,
        background=CF._background(graph, bg_nodes, spec.dev_node, 0.6, span,
                                  dev), device=dev, **kw)
        for dev in (card, "cpu")]
    got, want = runs
    assert not got.used_oracle and not want.used_oracle
    assert ((got.iters, got.converged, got.damped, got.rounds)
            == (want.iters, want.converged, want.damped, want.rounds))
    assert np.array_equal(got.residual_ps, want.residual_ps)
    for a, b in ((got.fabric_lat_ps, want.fabric_lat_ps),
                 (got.sf.latency_ps, want.sf.latency_ps),
                 (got.bisnp_lat_ps, want.bisnp_lat_ps),
                 (got.fabric_issue_ps, want.fabric_issue_ps),
                 (got.schedule.start, want.schedule.start),
                 (got.schedule.depart, want.schedule.depart)):
        assert torch.equal(a.cpu(), b)


def _rel_tables(dev, seed=3, n=200, h=5, c=4):
    """The reliability-marker family of ``test_streaming.py`` at a larger
    size: replay bytes, mixed flit and byte-exact channels, zero-byte
    link-down markers."""
    rng = np.random.default_rng(seed)
    fsize = rng.choice([0, 68, 256], c).astype(np.int64)
    ch = P.Channels(*(torch.from_numpy(x).to(dev) for x in (
        rng.integers(10, 100, c).astype(np.int64) * 1000,
        np.where(rng.random(c) < .5, rng.integers(100, 5000, c),
                 0).astype(np.int64),
        np.zeros(c, np.int64), np.zeros(c, np.int64), fsize,
        np.where(fsize == 68, 64,
                 np.where(fsize == 256, 236, 0)).astype(np.int64),
        np.zeros(c, np.int64))))
    valid = rng.random((n, h)) < .85
    hops = P.Hops(*(torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, c, (n, h)).astype(np.int32),
        rng.integers(0, 1200, (n, h)).astype(np.int64),
        rng.integers(0, 2, (n, h)).astype(np.int8),
        np.full((n, h), -1, np.int32),
        rng.integers(0, 2000, (n, h)).astype(np.int64), valid, valid,
        np.where(rng.random((n, h)) < .3,
                 rng.integers(0, 8, (n, h)) * 256, 0).astype(np.int64),
        np.where(rng.random((n, h)) < .2,
                 rng.integers(1, 4, (n, h)) * 100_000, 0).astype(np.int64))))
    issue = torch.from_numpy(np.sort(rng.integers(0, 50_000, n)).astype(
        np.int64)).to(dev)
    return hops, ch, issue


@pytest.mark.cuda
def test_cuda_backpointers_equal_cpu(card):
    """`extract_backpointers(check=True)` on a card schedule of the rel
    family (its replay holds the fused serve round's grants bit for bit):
    every backpointer array, the critical paths, the blame and the trace
    with flows equal to the same on the CPU run."""
    from repro_torch.core import critical_path as CP
    from repro_torch.core import trace_export as TX

    out = {}
    for dev in (card, torch.device("cpu")):
        hops, ch, issue = _rel_tables(dev)
        sched = P.simulate(hops, ch, issue)
        assert sched.converged
        bp = CP.extract_backpointers(hops, ch, sched, issue, check=True)
        paths = CP.critical_paths(bp)
        bl = CP.blame(bp, paths=paths)
        out[dev.type] = (bp, paths, bl, TX.schedule_trace(
            hops, ch, sched, flows=bp, blame=bl))
    (gbp, gpaths, gbl, gtrace), (cbp, cpaths, cbl, ctrace) = (
        out["cuda"], out["cpu"])
    assert int((cbp.bind == CP.B_RETRAIN).sum()) > 0
    for f in ("issue", "arrive", "start", "depart", "valid", "serving",
              "channel", "wire", "row_extra", "fixed", "bind", "qpred_row",
              "qpred_hop", "rsrc_row", "rsrc_hop", "gate_row"):
        a, b = getattr(gbp, f), getattr(cbp, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert gpaths == cpaths
    assert np.array_equal(gbl.table, cbl.table)
    assert gtrace == ctrace and TX.validate_trace(gtrace) == []


def _stream_tables(family, dev, seed=5, n=120, h=4, c=4):
    """Tables of the random, reliability-marker (`_rel_tables`) and
    fork/join families of ``test_streaming.py`` on ``dev``: turnarounds, a
    row-managed channel, zero-byte hops, and for ``"join"`` a layered
    fork/join DAG."""
    if family == "rel":
        return _rel_tables(dev, seed=seed, n=n, h=h, c=c)
    rng = np.random.default_rng(seed)
    rowm = np.arange(c) == c - 1
    ch = P.Channels(*(torch.from_numpy(x).to(dev) for x in (
        rng.integers(10, 100, c).astype(np.int64) * 1000,
        np.where(rng.random(c) < .5, rng.integers(100, 5000, c),
                 0).astype(np.int64),
        np.where(rowm, 1000, 0).astype(np.int64),
        np.where(rowm, 9000, 0).astype(np.int64))))
    chan = rng.integers(0, c, (n, h)).astype(np.int32)
    nbytes = np.where(rng.random((n, h)) < 0.2, 0,
                      rng.integers(1, 300, (n, h))).astype(np.int64)
    valid = rng.random((n, h)) < .85
    join = {}
    if family == "join":
        jid = np.full(n, -1, np.int32)
        jwait = np.full(n, -1, np.int32)
        jarity = np.zeros(n, np.int32)
        layers = np.split(np.arange(n), [n // 3, 2 * n // 3])
        grp = 0
        for up, dn in zip(layers[:-1], layers[1:]):
            for w in dn[rng.random(dn.shape[0]) < 0.5]:
                members = up[(rng.random(up.shape[0]) < 0.1)
                             & (jid[up] < 0)]
                if members.size:
                    jid[members] = grp
                    jwait[w], jarity[w] = grp, members.size
                    grp += 1
        join = {k: torch.from_numpy(v).to(dev) for k, v in
                (("join_id", jid), ("join_wait", jwait),
                 ("join_arity", jarity))}
    hops = P.Hops(*(torch.from_numpy(x).to(dev) for x in (
        chan, nbytes, rng.integers(0, 2, (n, h)).astype(np.int8),
        np.where(chan == c - 1, rng.integers(0, 3, (n, h)),
                 -1).astype(np.int32),
        rng.integers(0, 2000, (n, h)).astype(np.int64), valid, valid)),
        **join)
    issue = torch.from_numpy(np.sort(rng.integers(0, 50_000, n)).astype(
        np.int64)).to(dev)
    return hops, ch, issue


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["random", "rel", "join"])
def test_cuda_stream_equals_monolithic_and_cpu(card, family):
    """`simulate_stream` on the card: every settled item's start, depart
    and arrive, every completion and gated first-hop arrival, the blame and
    the peak backlog equal the card's monolithic schedule, and the CPU
    stream's ``collected`` and summary; the fused serve round launches once
    per window round, plus one retraining replay per window with retraining
    tables."""
    from repro_torch.core import streaming as PS
    from repro_torch.studies.streaming import stream_matches_monolithic

    out = {}
    for dev in (card, torch.device("cpu")):
        hops, ch, issue = _stream_tables(family, dev)
        mono = P.simulate(hops, ch, issue)
        assert mono.converged
        before = K.LAUNCHES["serve_round"]
        res = PS.simulate_stream(PS.stream_windows(hops, issue, 7), ch,
                                 collect_schedule=True)
        launches = K.LAUNCHES["serve_round"] - before
        stream_matches_monolithic(hops, ch, issue, mono, res, dev.type)
        out[dev.type] = (res, launches)
    (gres, glaunch), (cres, _) = out["cuda"], out["cpu"]
    for key, want in cres.collected.items():
        assert np.array_equal(gres.collected[key], want), key
    gs, cs = gres.summary(), cres.summary()
    for key, want in cs.items():
        if key == "blame":
            for b, w in want.items():
                assert np.array_equal(np.asarray(gs[key][b]),
                                      np.asarray(w)), b
        else:
            assert np.array_equal(np.asarray(gs[key]), np.asarray(want)), key
    assert gres.oracle_windows == 0 and gres.carried_peak > 0
    replays = gres.windows if family == "rel" else 0
    assert glaunch == gres.rounds + replays


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_cross_and_d96_equal_plain(card, dtype):
    """The model families' new cases: non-causal with fewer queries than
    keys (whisper's cross attention, S 1 in decode) and head dim 96 inside
    the D-128 tile (phi-3-vision), causal with G 1 and G 8; each call on
    the kernel its dtype and head dim select."""
    gen = torch.Generator(device=card).manual_seed(2)
    for b, kv, g, s, t, d, causal in [
            (2, 4, 1, 1, 300, 64, False), (2, 4, 1, 7, 300, 64, False),
            (2, 4, 1, 100, 300, 64, False), (1, 4, 1, 300, 300, 64, False),
            (1, 2, 1, 65, 65, 96, True), (1, 4, 1, 300, 300, 96, True),
            (1, 1, 8, 200, 200, 128, True), (1, 2, 2, 70, 131, 96, False)]:
        q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
                   for shape in ((b, s, kv * g, d), (b, t, kv, d),
                                 (b, t, kv, d)))
        out = []
        counts = launched(FA.LAUNCHES, lambda: out.append(
            FA.flash_attention_kernel(q, k, v, causal=causal)))
        tc = FA.uses_tensor_cores(dtype, d)
        assert counts == {"flash_attention": int(not tc),
                          "flash_attention_tc": int(tc)}, (s, t, d)
        want = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            assert torch.allclose(out[0], want, atol=1e-4, rtol=1e-4), (s, d)
        else:
            assert bf16_within_ulps(out[0], want, 2), (s, t, d)


def _family_run(model, toks, fe, calls, n_steps=3):
    """Prefill and ``n_steps`` teacher-forced decode steps: the logits of
    each, and how many routings (`calls`) each step made."""
    dev = model.device
    n = toks.shape[1] - n_steps
    logits, cache = TF.prefill(model, toks[:, :n].to(dev), 64,
                               frontend_embeds=(None if fe is None
                                                else fe.to(dev)))
    out, ends = [logits[:, 0].float().cpu()], [len(calls)]
    for i in range(n_steps):
        logits, cache = TF.decode_step(
            model, cache, toks[:, n + i:n + i + 1].to(dev),
            torch.full((toks.shape[0], 1), n + i, dtype=torch.int32,
                       device=dev))
        out.append(logits[:, 0].float().cpu())
        ends.append(len(calls))
    return out, ends


def family_models_agree(arch, dev, monkeypatch):
    """``arch``'s smoke model on ``dev`` against the CPU: a 12-token prefill
    of two rows (with the frontend embeddings it takes) and three decode
    steps, logits at ``5e-2``; returns the flash launches on ``dev``.  A
    MoE routing that differs must be a near tie (K-th and (K+1)-th
    probabilities within 0.02), and a row is held only until one of its
    tokens is routed otherwise (from then on its logits may differ by more
    than the tolerance)."""
    cfg = get_smoke_config(arch)
    cpu = TF.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    other = TF.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu").to(dev)
    rng = np.random.default_rng(1)
    b, n = 2, 12
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, n + 3)))
    fe = None
    if cfg.enc_layers or cfg.vision_patches:
        rows = cfg.enc_frames if cfg.enc_layers else cfg.vision_patches
        fe = torch.from_numpy(rng.normal(0, 1, (b, rows, cfg.d_model))).to(
            torch.bfloat16)
    calls = {"dev": [], "cpu": []}
    route = MOE.route
    side = ["dev"]

    def spy(router, xt, **kw):
        calls[side[0]].append(route(router, xt, **kw))
        return calls[side[0]][-1]

    monkeypatch.setattr(MOE, "route", spy)
    before = dict(FA.LAUNCHES)
    got, ends = _family_run(other, toks, fe, calls["dev"])
    launches = {k: FA.LAUNCHES[k] - before[k] for k in before}
    side[0] = "cpu"
    want, _ = _family_run(cpu, toks, fe, calls["cpu"])
    held = torch.ones(b, dtype=torch.bool)
    start = 0
    for step, end in enumerate(ends):
        for r, q in zip(calls["dev"][start:end], calls["cpu"][start:end]):
            moved = (torch.sort(r.experts.cpu(), dim=-1).values
                     != torch.sort(q.experts, dim=-1).values).any(dim=-1)
            top = torch.sort(q.probs, dim=-1, descending=True).values
            gap = top[..., cfg.moe.top_k - 1] - top[..., cfg.moe.top_k]
            assert not bool(moved.any()) or float(gap[moved].max()) < 0.02
            # tokens are routed row-major: (row, position) flattened
            held &= ~moved.reshape(b, -1).any(dim=-1)
        start = end
        assert torch.allclose(got[step][held], want[step][held], atol=5e-2,
                              rtol=5e-2), (arch, step)
        assert not bool(torch.isnan(got[step]).any())
    return launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "whisper-base",
                                  "phi-3-vision-4.2b"])
def test_cuda_family_model_equals_cpu(card, arch, monkeypatch):
    """The model families' smoke models on the card against the CPU
    (`family_models_agree`), and the card's flash launches: one per
    attention layer of the prefill (whisper: also each encoder and each
    cross-attention layer) and one per cross-attention layer a decode
    step, on the kernel bf16 at the model's head dim selects."""
    cfg = get_smoke_config(arch)
    launches = family_models_agree(arch, card, monkeypatch)
    per_prefill = cfg.n_layers + (cfg.n_layers + cfg.enc_layers
                                  if cfg.enc_layers else 0)
    per_step = cfg.n_layers if cfg.enc_layers else 0
    name = ("flash_attention_tc"
            if FA.uses_tensor_cores(torch.bfloat16, cfg.head_dim)
            else "flash_attention")
    assert launches == {n: (per_prefill + 3 * per_step) * (n == name)
                        for n in launches}, launches


def _grad_ok(got, want):
    """|got - want| <= 2 bf16 spacings of want + 1e-3 max|want| + 1e-5."""
    w = want.float()
    spacing = torch.exp2(torch.floor(torch.log2(
        w.abs().clamp_min(2.0 ** -100))) - 7)
    allow = 2 * spacing + 1e-3 * float(w.abs().max()) + 1e-5
    return bool(((got.float() - w).abs() <= allow).all())


@pytest.mark.cuda
def test_cuda_flash_bwd_kernel_equals_plain(card):
    """The backward kernel (bf16, D 16 to 256) around its 64-key and
    64-row tiles and the slices of each key tile's walk: causal, windowed,
    non-causal, S < T, GQA, MQA, one query; the forward with the LSE
    pointer bit-identical to the one without; each call counted once on
    the backward; a second call on the same inputs bit for bit equal to
    the first."""
    gen = torch.Generator(device=card).manual_seed(3)
    for b, kv, g, s, t, d, causal, window in [
            (1, 1, 4, 64, 64, 16, True, 32), (2, 2, 3, 129, 200, 128, True, 0),
            (1, 2, 2, 70, 131, 96, False, 0), (1, 2, 1, 1, 1, 64, True, 0),
            (1, 1, 2, 300, 300, 256, True, 40),
            (1, 2, 4, 257, 257, 64, True, 100),
            (1, 1, 10, 1000, 1000, 256, True, 2048),
            (1, 8, 1, 100, 400, 64, False, 0)]:
        q, k, v, do = (torch.randn(shape, generator=gen, device=card).to(
            torch.bfloat16) for shape in ((b, s, kv * g, d), (b, t, kv, d),
                                          (b, t, kv, d), (b, s, kv * g, d)))
        kw = dict(causal=causal, window=window)
        out, lse = FA.flash_attention_kernel(q, k, v, return_lse=True, **kw)
        assert torch.equal(out, FA.flash_attention_kernel(q, k, v, **kw))
        before = FAB.BWD_LAUNCHES["flash_attention_bwd"]
        got = FAB.flash_attention_bwd_kernel(q, k, v, out, do, lse, **kw)
        assert FAB.BWD_LAUNCHES["flash_attention_bwd"] == before + 1
        want = flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
        again = FAB.flash_attention_bwd_kernel(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        for x, gx, w, g2 in zip((q, k, v), got, want, again):
            assert gx.dtype == torch.bfloat16 and gx.shape == x.shape
            assert _grad_ok(gx, w), (s, t, d, window)
            assert torch.equal(gx, g2), (s, t, d, window)


@pytest.mark.cuda
def test_cuda_flash_tc_wgmma_kernel_equals_plain_with_lse(card):
    """The tensor-core forward (wgmma fed by TMA, one or two consumer
    warpgroups of 64 rows) at D 16, 64, 96, 128 and 256 around its 64-key
    tiles and 128-row (64 at D 256) blocks: one query, S < T, ragged tiles,
    causal, windowed and non-causal, GQA and MQA; the output within 2 ulps
    of the plain version, the base-2 LSE within 1e-3 of the plain one, the
    call that writes it bit-identical to the one that does not, and two
    calls bit-equal."""
    gen = torch.Generator(device=card).manual_seed(11)
    for b, kv, g, s, t, d, causal, window in [
            (1, 1, 4, 1, 1, 16, True, 0), (2, 2, 2, 1, 77, 64, False, 0),
            (1, 2, 3, 63, 200, 96, True, 0),
            (1, 1, 2, 129, 129, 128, True, 40),
            (2, 1, 3, 200, 333, 128, False, 70),
            (1, 1, 10, 300, 300, 256, True, 64),
            (1, 2, 1, 65, 130, 256, False, 0),
            (1, 4, 2, 127, 127, 16, True, 9),
            (4, 8, 1, 1, 1500, 64, False, 0)]:
        q, k, v = (torch.randn(shape, generator=gen, device=card).to(
            torch.bfloat16) for shape in ((b, s, kv * g, d), (b, t, kv, d),
                                          (b, t, kv, d)))
        kw = dict(causal=causal, window=window)
        out = FA.flash_attention_kernel(q, k, v, **kw)
        again, lse = FA.flash_attention_kernel(q, k, v, return_lse=True,
                                               **kw)
        want, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, again), (s, t, d)
        assert bf16_within_ulps(out, want, 2), (s, t, d, window)
        assert float((lse - lse_ref).abs().max()) <= 1e-3, (s, t, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12])
def test_cuda_flash_padded_head_dim_gradients_equal_plain(card, d):
    """bf16 at the smoke configs' head dims 8 and 12 under autograd: the op
    pads q, k and v with zero columns to 16 for both tensor-core kernels
    (one launch each), divides by the true D's square root and slices back;
    its output within 2 ulps of the plain version and its gradients within
    the backward's bound of the plain backward at the true D."""
    from repro_torch.kernels.flash_attention import ops as FAO

    gen = torch.Generator(device=card).manual_seed(d)
    for b, kv, g, s, t, causal, window in [
            (8, 2, 4, 32, 32, True, 0), (2, 4, 1, 70, 131, False, 0),
            (1, 1, 3, 100, 100, True, 17)]:
        q, k, v, do = (torch.randn(shape, generator=gen, device=card).to(
            torch.bfloat16) for shape in ((b, s, kv * g, d), (b, t, kv, d),
                                          (b, t, kv, d), (b, s, kv * g, d)))
        kw = dict(causal=causal, window=window)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = (dict(FA.LAUNCHES), FAB.BWD_LAUNCHES["flash_attention_bwd"])
        out = FAO.flash_attention(*leaves, **kw)
        grads = torch.autograd.grad(out, leaves, do)
        assert {n: FA.LAUNCHES[n] - before[0][n] for n in FA.LAUNCHES} == {
            "flash_attention": 0, "flash_attention_tc": 1}
        assert FAB.BWD_LAUNCHES["flash_attention_bwd"] == before[1] + 1
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        want, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
        assert bf16_within_ulps(out.detach(), want, 2), (s, t, d)
        plain = flash_attention_bwd_plain(q, k, v, out.detach(), do, lse,
                                          **kw)
        torch.cuda.synchronize()
        for x, gx, w in zip((q, k, v), grads, plain):
            assert gx.shape == x.shape
            assert _grad_ok(gx, w), (s, t, d, window)


@pytest.mark.cuda
def test_cuda_flash_gradient_refuses_float32(card):
    q = torch.randn(1, 8, 2, 64, device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="bf16"):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        flash_attention(q, q.detach()[:, :, :1], q.detach()[:, :, :1])


@pytest.mark.cuda
def test_cuda_rglru_reverse_equals_plain(card):
    """The reverse mode bit-equal to its blocked emulation at the kernel's
    chunk, and within 1e-5 of the largest value of the plain reverse walk,
    around the chunk and tile edges and at the model's width."""
    gen = torch.Generator(device=card).manual_seed(5)
    for b, s, d in [(1, 1, 1), (2, 15, 31), (1, 17, 33), (4, 257, 64),
                    (1, 4096, 2560)]:
        r = torch.rand(b, s, d, generator=gen, device=card)
        a = torch.exp(8.0 * r * torch.nn.functional.logsigmoid(
            torch.linspace(2.2, 6.9, d, device=card)))
        gr = torch.randn(b, s, d, generator=gen, device=card)
        before = RK.REVERSE_LAUNCHES["rglru_scan_reverse"]
        lam = RK.rglru_scan_kernel(a, gr, reverse=True)
        assert RK.REVERSE_LAUNCHES["rglru_scan_reverse"] == before + 1
        want = rglru_scan_bwd_plain(a, gr)
        torch.cuda.synchronize()
        assert torch.equal(lam, rglru_scan_blocked(a, gr, CHUNK,
                                                   reverse=True))
        scale = max(1.0, float(want.abs().max()))
        assert float((lam - want).abs().max()) <= 1e-5 * scale, (b, s, d)


@pytest.mark.cuda
def test_cuda_train_step_equals_cpu(card):
    """recurrentgemma-2b's smoke config (D 16, so the tensor-core flash
    kernel and its backward) and mamba2-1.3b's (P 16, N 16: the tensor-core
    SSD kernel and its backward): `transformer.loss_fn` and every gradient
    leaf on the card against the same model on the CPU, through the kernels
    in both directions (each ssd layer twice forward, under the
    checkpoint's recompute, and once backward)."""
    cfg = get_smoke_config("recurrentgemma-2b")
    cpu = TF.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    cpu.requires_grad_(True)
    import copy

    dev = copy.deepcopy(cpu).to(card)
    toks = torch.randint(0, cfg.vocab, (2, 48),
                         generator=torch.Generator().manual_seed(1))
    before = (FAB.BWD_LAUNCHES["flash_attention_bwd"],
              RK.REVERSE_LAUNCHES["rglru_scan_reverse"])
    got, _ = TF.loss_fn(dev, {"tokens": toks.to(card),
                              "labels": toks.to(card)})
    got.backward()
    kinds = [key.split("_", 1)[1] for key, _ in dev.keys]
    assert (FAB.BWD_LAUNCHES["flash_attention_bwd"] - before[0],
            RK.REVERSE_LAUNCHES["rglru_scan_reverse"] - before[1]) == (
        kinds.count("attn_local"), kinds.count("rglru"))
    want, _ = TF.loss_fn(cpu, {"tokens": toks, "labels": toks})
    want.backward()
    assert abs(float(got.detach()) - float(want.detach())) <= 5e-2
    for (name, pd), (_, pc) in zip(dev.named_parameters(),
                                   cpu.named_parameters()):
        gd, gc = pd.grad.float().cpu(), pc.grad.float()
        assert bool(torch.isfinite(gd).all()), name
        assert float((gd - gc).norm()) <= 5e-2 * max(float(gc.norm()),
                                                     1e-12), name
    m2 = get_smoke_config("mamba2-1.3b")
    cpu = TF.init_params(m2, torch.Generator().manual_seed(0), device="cpu")
    cpu.requires_grad_(True)
    dev = copy.deepcopy(cpu).to(card)
    before = (SK.LAUNCHES["ssd_chunk_tc"], SK.LAUNCHES["ssd_chunk"],
              SKB.BWD_LAUNCHES["ssd_chunk_bwd"])
    got, _ = TF.loss_fn(dev, {"tokens": toks.to(card),
                              "labels": toks.to(card)})
    got.backward()
    layers = [key.split("_", 1)[1] for key, _ in dev.keys].count("ssd")
    assert (SK.LAUNCHES["ssd_chunk_tc"] - before[0],
            SK.LAUNCHES["ssd_chunk"] - before[1],
            SKB.BWD_LAUNCHES["ssd_chunk_bwd"] - before[2]) == (
        2 * layers, 0, layers)
    want, _ = TF.loss_fn(cpu, {"tokens": toks, "labels": toks})
    want.backward()
    assert abs(float(got.detach()) - float(want.detach())) <= 5e-2
    for (name, pd), (_, pc) in zip(dev.named_parameters(),
                                   cpu.named_parameters()):
        gd, gc = pd.grad.float().cpu(), pc.grad.float()
        assert bool(torch.isfinite(gd).all()) and bool(gd.ne(0).any()), name
        assert float((gd - gc).norm()) <= 5e-2 * max(float(gc.norm()),
                                                     1e-12), name

