"""Batch tokenization into fixed-length id arrays
(``jcf_tpu/tokenizer/tokenize.py``): SOT + ids + EOT, zero-padded to the
context length; over-long inputs raise or are truncated with EOT kept as
the last token. int32 ids."""

from __future__ import annotations

from typing import Iterable, List, Union

import numpy as np

from jcf_tpu_torch.tokenizer.bpe import get_tokenizer

CONTEXT_LENGTH = 77
SOT_TOKEN = 49406
EOT_TOKEN = 49407


def tokenize(texts: Union[str, Iterable[str]], context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """Tokenize one or more strings into a [N, context_length] int32 array."""
    if isinstance(texts, str):
        texts = [texts]
    texts = list(texts)
    tok = get_tokenizer()
    all_ids: List[List[int]] = [[tok.sot_token] + tok.encode(t) + [tok.eot_token] for t in texts]
    out = np.zeros((len(all_ids), context_length), dtype=np.int32)
    for row, ids in enumerate(all_ids):
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {texts[row]} is too long for context length "
                                   f"{context_length}")
            ids = ids[:context_length]
            ids[-1] = tok.eot_token
        out[row, : len(ids)] = ids
    return out
