from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm  # noqa: F401
from .compression import (  # noqa: F401
    CompressionState, compressed_psum, compression_init, ef_int8_compress,
)
from .schedule import warmup_cosine  # noqa: F401
