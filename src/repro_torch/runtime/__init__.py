# Serving runtime of the port: the single-device executor (inmem, base and
# exact variants) and the mesh executor (sharded, sharded-base).
from .executor import SearchExecutor, SearchHandle, bucket_size, pad_batch  # noqa: F401
from .sharded import SHARDED_VARIANTS, ShardedSearchExecutor  # noqa: F401
