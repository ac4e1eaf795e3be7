"""PyTorch port on a CUDA card: the hand-written kernel against its plain
version, and the engine on the card against the engine on the CPU.

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
