"""Static-analysis layer of the port: the verifier smoke.

``python -m repro_torch.analysis.verify_smoke`` runs the fabric-IR verifier
(`repro_torch.core.verify`) over every lowering path the studies exercise,
lowered by the port on the card (``--device cpu`` on the host).

The reference's jit-safety lint (``repro.analysis.jitlint`` and its
baseline) has no counterpart: the port has no ``jax.jit`` to keep free of
host syncs.  The kernel-signature rule holds for the port through the
reference's lint, run by the port's tests.
"""
