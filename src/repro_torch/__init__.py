"""PyTorch/CUDA port of the CXL fabric simulator (``repro``).

Beside the JAX reference package, never importing it: ``repro_torch.core``
is the host lowering, the exact FCFS engine and its event-driven oracle;
``repro_torch.kernels`` holds the hand-written Hopper kernels with their
plain PyTorch versions.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
