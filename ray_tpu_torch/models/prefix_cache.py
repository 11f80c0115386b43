"""KV block sizing, copied from `ray_tpu/models/prefix_cache.py`.

Only `block_bytes` is here: the paged engine sizes its pool with it.
The prefix-cache trie (`PrefixCacheIndex`) waits for the prefix-cache
engine feature (ROADMAP.md Queue A).
"""

from __future__ import annotations


def block_bytes(n_layers: int, block_tokens: int, kv_heads: int,
                head_dim: int, dtype_bytes: int, *,
                per_layer: bool = False) -> int:
    """Device bytes one pool block occupies (K and V).

    A block id indexes the ``NB`` axis of BOTH pool tensors
    ``[L, NB, T, KV, D]``, so one block holds T tokens' K/V for ALL
    ``n_layers`` layers: the default is the layer-summed figure
    ``2 * L * T * KV * D * dtype`` (the number a byte budget divides
    by); ``per_layer=True`` returns one layer's slice.

    Pool sizing from a byte budget is exact: a budget of
    ``k * block_bytes(...)`` buys exactly k usable blocks (the reserved
    null block 0 rides on top)."""
    layers = 1 if per_layer else n_layers
    return 2 * layers * block_tokens * kv_heads * head_dim * dtype_bytes
