from .attention import FusedAttention, attention_reference, fused_attention
from .groupnorm import FusedGroupNormSwish, fused_group_norm_swish, group_norm_swish_reference

__all__ = [
    "FusedAttention",
    "FusedGroupNormSwish",
    "attention_reference",
    "fused_attention",
    "fused_group_norm_swish",
    "group_norm_swish_reference",
]
