from .decode_attn import (SPLIT_KEYS, WIDE_KV, decode_attn_call,
                          split_bounds, split_plan)
from .ops import decode_attention
from .paged import (gather_layer_paged, paged_decode_attention,
                    paged_decode_attention_plain,
                    paged_decode_attention_split)
from .ref import (decode_attention_grouped, decode_attention_reference,
                  decode_attention_split)
