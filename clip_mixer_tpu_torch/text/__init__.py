"""Host-side text processing: BPE tokenizer and the public tokenize()."""

from clip_mixer_tpu_torch.text.bpe import ClipBPE, get_tokenizer
from clip_mixer_tpu_torch.text.tokenize import tokenize

__all__ = ["ClipBPE", "get_tokenizer", "tokenize"]
