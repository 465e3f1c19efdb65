"""Fused traversal-step kernels: one whole Algorithm-2 hop per query (K1),
the hop on precomputed distances (K6), and the owner-shard gather + ADC of
the sharded search (K7)."""
