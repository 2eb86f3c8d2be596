"""PyTorch/CUDA port of the TRIM-KV serving system.

Mirrors the layout of the JAX package (``src/repro``), which stays the
reference it is tested against. Only the dense TRIM-KV serving path is
ported so far: configs, layer primitives, the slot cache, the TRIM-KV
policy, the dense block and stack, the engine and a one-shot CLI, with
hand-written CUDA kernels for decode, chunk and prefill attention.
"""
