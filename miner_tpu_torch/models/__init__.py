from miner_tpu_torch.models.miner import CategoryEmbedding, Miner
from miner_tpu_torch.models.news_encoder import NewsEncoder
from miner_tpu_torch.models.plm import PLMConfig, TransformerPLM
from miner_tpu_torch.models.poly_attention import PolyAttention, TargetAwareAttention

__all__ = [
    "CategoryEmbedding",
    "Miner",
    "NewsEncoder",
    "PLMConfig",
    "PolyAttention",
    "TargetAwareAttention",
    "TransformerPLM",
]
