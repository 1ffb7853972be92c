"""Public ``tokenize()``: zero-padded ``int32 [N, context_length]`` numpy
arrays of ``<sot> + BPE(text) + <eot>``.

Counterpart of ``clip_mixer_tpu/text/tokenize.py``. With ``truncate=True``
over-long sequences are clipped and position ``context_length-1`` is forced
to ``<eot>``; otherwise a RuntimeError is raised.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from clip_mixer_tpu_torch.text.bpe import get_tokenizer


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = 77,
    truncate: bool = False,
) -> np.ndarray:
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids: List[int] = [tok.sot_id] + tok.encode(text) + [tok.eot_id]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {texts[i]} is too long for context length {context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = tok.eot_id
        out[i, : len(ids)] = ids
    return out
