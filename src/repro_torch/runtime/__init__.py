# Serving runtime of the port: the search executor (inmem, base and exact variants).
from .executor import SearchExecutor, SearchHandle, bucket_size, pad_batch  # noqa: F401
