# PQ asymmetric-distance computation kernel (paper §4.5).
