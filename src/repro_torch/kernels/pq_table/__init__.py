"""PQ distance-table construction kernel (paper §4.2), K8."""
