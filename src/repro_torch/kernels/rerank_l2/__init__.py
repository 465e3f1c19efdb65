# Exact-L2 re-ranking distance kernel (paper §4.9).
