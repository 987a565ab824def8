from miner_tpu_torch.data.device_table import NewsTable
from miner_tpu_torch.data.news_store import NewsStore
from miner_tpu_torch.data.tokenization import HashTokenizer, load_tokenizer

__all__ = ["HashTokenizer", "NewsStore", "NewsTable", "load_tokenizer"]
