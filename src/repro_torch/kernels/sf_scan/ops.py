"""Public entry point of the snoop-filter protocol scan: device dispatch.

``sf_scan(jobs)`` runs each `ref.ScanJob` (one request stream, its starting
state and its configuration) through the protocol and returns, per job,
``(outs, final_state)`` as `ref.sf_scan_ref` does.  The reference has no
kernel for this function: it leaves ``simulate_sf``'s ``lax.scan`` to XLA,
which compiles it into one device loop.  The tensors' device picks the path:
the CUDA kernel (`kernel.sf_scan_kernel`, all jobs in one launch, one thread
block each) when they lie on the card, the plain version (`ref.sf_scan_ref`,
job by job) when they lie on the CPU.  On the card it launches the kernel or
raises; nothing falls back.
"""

from __future__ import annotations

from .kernel import sf_scan_kernel
from .ref import ScanJob, sf_scan_ref


def sf_scan(jobs: list[ScanJob]) -> list:
    """Scan every job; all tensors of all jobs on one device."""
    jobs = list(jobs)
    if not jobs:
        return []
    dev = jobs[0].addr.device
    if any(j.addr.device != dev for j in jobs):
        raise ValueError("sf_scan takes jobs on one device")
    if dev.type == "cuda":
        return sf_scan_kernel(jobs)
    return sf_scan_ref(jobs)
