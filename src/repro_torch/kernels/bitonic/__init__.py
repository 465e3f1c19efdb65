"""Bitonic sort and worklist-merge kernels (paper §4.7-§4.8), staged mode."""
