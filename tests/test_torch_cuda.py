"""PyTorch port on a CUDA card: the hand-written kernels against their plain
versions, and the engine (one run and a stacked sweep) on the card against
the engine on the CPU.

Every test here is marked ``cuda`` and skips without a card (the CUDA
kernel has no CPU mode).  The file imports neither JAX nor the reference
package, so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: exact (int64 picoseconds).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.kernels.flit_pack import kernel as FK  # noqa: E402
from repro_torch.kernels.flit_pack.ref import flit_pack_ref  # noqa: E402
from repro_torch.kernels.link_contention import kernel as LK  # noqa: E402
from repro_torch.kernels.link_contention.ref import (  # noqa: E402
    random_stream, segmented_depart_ref)
from repro_torch.kernels.serve_round import kernel as K  # noqa: E402
from repro_torch.kernels.serve_round.ref import (random_maps,  # noqa: E402
                                                 serve_scan_ref)


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
        assert torch.equal(got, serve_scan_ref(*maps)), k


@pytest.mark.cuda
def test_cuda_simulate_equals_cpu(card):
    topo = P.tree(4, bw_MBps=64_000, fixed_ps=26_000)
    mems = [int(m) for m in topo.memories()]
    specs = [P.RequesterSpec(node=int(r), n_requests=40, targets=mems,
                             issue_interval_ps=500, seed=i)
             for i, r in enumerate(topo.requesters())]
    wl = P.build_workload(topo.build(), specs, device=card)
    before = K.LAUNCHES["serve_scan"]
    gpu = P.simulate(wl.hops, wl.channels, wl.issue_ps)
    assert K.LAUNCHES["serve_scan"] - before == gpu.rounds
    cpu = P.simulate(P.hops_from_arrays(wl.hops, device="cpu"),
                     P.channels_from_arrays(wl.channels, device="cpu"),
                     P.issue_from_array(wl.issue_ps, device="cpu"))
    assert gpu.converged and gpu.rounds == cpu.rounds
    for f in ("start", "depart", "arrive", "complete"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(one_segment=True),
                                dict(singletons=True),
                                dict(lead_minus_one=2100)])
def test_cuda_depart_kernel_equals_plain(card, kw):
    """Bit-equal at block edges, int64 and int32 channels."""
    blk = LK.block_items()
    for k in (1, 2, blk - 1, blk, blk + 1, 3 * blk + 5, 40_000):
        cols = [torch.from_numpy(x).to(card)
                for x in random_stream(k, k, **dict(
                    kw, lead_minus_one=min(kw.get("lead_minus_one", 0), k)))]
        want = segmented_depart_ref(*cols)
        for chan in (cols[0], cols[0].int()):
            got = LK.segmented_depart(chan, *cols[1:])
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, kw, chan.dtype)


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
        before = K.LAUNCHES["serve_scan"]
        out[dev.type] = P.simulate_stacked(
            P.stack_members([wl.hops] * 3), P.stack_members(chans),
            torch.stack([wl.issue_ps] * 3))
        if dev.type == "cuda":
            assert K.LAUNCHES["serve_scan"] - before == max(
                out["cuda"].rounds)
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.rounds == cpu.rounds and all(gpu.converged)
    for f in ("start", "depart", "arrive", "complete"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
