"""Fused traversal-step kernels: one whole Algorithm-2 hop per query (K1),
and the hop on precomputed distances (K6)."""
