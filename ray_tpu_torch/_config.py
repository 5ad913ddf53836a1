"""Serving defaults read by models/kv_paging.py and serve/batching.py: the
values of the same-named `serve_*` flags of ray_tpu/_private/config.py,
as plain constants (no environment overrides in the port)."""

# decode slots per ContinuousBatcher
SERVE_GENERATION_MAX_BATCH_SIZE = 8
# coalescing window of an EMPTY running batch before its first step
SERVE_GENERATION_BATCH_WAIT_TIMEOUT_S = 0.01
# tokens per physical KV-cache block
SERVE_KV_BLOCK_TOKENS = 64
# pool size in blocks (0 = dense equivalent plus the null block)
SERVE_KV_CACHE_BLOCKS = 0
# chunked prefill chunk size in tokens (0 = whole-prompt prefill)
SERVE_PREFILL_CHUNK_TOKENS = 0
# keep full prompt blocks for prefix reuse after release
SERVE_KV_PREFIX_CACHE = True
