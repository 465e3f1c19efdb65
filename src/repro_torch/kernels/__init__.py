# Hand-written Hopper kernels (csrc/*.cu) with their plain PyTorch versions:
#   pq_adc       -- ADC of R candidates per query (medoid seed; staged distances)
#   pq_table     -- PQ distance table (its own entry point, off the search path)
#   search_step  -- one whole Algorithm-2 hop per query; the hop on
#                   precomputed distances (exact variant, sharded search); the
#                   owner-shard gather + ADC (sharded search)
#   bitonic      -- candidate sort and worklist merge (staged mode)
#   rerank_l2    -- exact squared L2 for the re-rank
#   autotune     -- persisted tuning winners of the fused hop per (device kind,
#                   bucket, R, m), and the sweep that finds them
