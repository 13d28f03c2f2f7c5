"""PyTorch / CUDA port of the FIGCache DRAM simulator (``repro``).

Mirrors the layout of the JAX package: ``repro_torch.core.dram`` is the
counterpart of ``repro.core.dram`` and so on.  The port imports torch and
numpy only — never jax, never ``repro`` — and runs on the CUDA device unless
the caller passes ``device="cpu"`` (``repro_torch.device.resolve_device``).
"""
