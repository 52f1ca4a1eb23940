"""Model zoo of the PyTorch port — the dense family so far."""

from .model import Model, build_model
from .kvcache import (AttnCache, BlockAllocator, PagedAttnCache,
                      init_attn_cache, init_paged_attn_cache)
