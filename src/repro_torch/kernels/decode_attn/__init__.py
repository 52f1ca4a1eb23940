from .decode_attn import decode_attn_call
from .ops import decode_attention
from .paged import (gather_layer_paged, paged_decode_attention,
                    paged_decode_attention_plain)
from .ref import decode_attention_grouped, decode_attention_reference
