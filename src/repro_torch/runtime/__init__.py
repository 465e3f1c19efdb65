# Serving runtime of the port: the search executor (inmem variant).
from .executor import SearchExecutor, SearchHandle, bucket_size, pad_batch  # noqa: F401
