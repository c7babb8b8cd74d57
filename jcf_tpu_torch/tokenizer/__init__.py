"""CLIP BPE tokenizer of the port (``jcf_tpu/tokenizer``), without ``regex``."""

from jcf_tpu_torch.tokenizer.bpe import SimpleTokenizer, get_tokenizer
from jcf_tpu_torch.tokenizer.tokenize import CONTEXT_LENGTH, EOT_TOKEN, SOT_TOKEN, tokenize

__all__ = ["SimpleTokenizer", "get_tokenizer", "tokenize", "SOT_TOKEN", "EOT_TOKEN",
           "CONTEXT_LENGTH"]
