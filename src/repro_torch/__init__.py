"""repro_torch — the PyTorch/CUDA port of the DxPTA co-search system.

A second package beside the JAX reference `repro`, module for module:
`core` (the cost model, the factorized product space, Alg. 1 and the
min-EDP search engines) and `kernels` (hand-written Hopper kernels, each
beside its plain PyTorch version). It imports torch and numpy, never jax
and never `repro`; `interop.from_reference` carries the reference's
dataclasses across by duck typing.

Entry points run on "cuda" by default and raise when no card is present;
`device="cpu"` runs the plain PyTorch version of every kernel.
"""
