# BANG core, ported to PyTorch:
#   kmeans / pq        -- PQ codec + PQDistTable (stage 1)
#   bloom              -- visited-set bloom filter (§4.4)
#   vamana             -- Vamana graph construction (host numpy) + the graph container
#   worklist / search  -- Algorithm 2 batched greedy search (stage 2)
#   hostrows           -- host tables (pinned) whose rows go to the device (base)
#   rerank             -- exact-distance re-ranking (stage 3, §4.9)
#   bang               -- BangIndex public API (three-stage pipeline)
from .bang import BangIndex, SearchStats, brute_force_knn, recall_at_k  # noqa: F401
from .search import KERNEL_MODES, SearchConfig  # noqa: F401
