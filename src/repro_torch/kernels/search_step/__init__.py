"""Fused traversal-step kernel: one whole Algorithm-2 hop per query."""
