"""Prompt tokenization: the sentinel splice of the chat path.

Counterpart of ``psalm_tpu/data/tokenization.py::tokenize_special`` (the
reference's tokenizer_special_tokens regex splice, train_datasets.py:156-173,
with the RefCOCO variant's <refer>): the sentinels <image>, <seg>, <cls>,
<region> and <refer> become their negative ids, and the text between them
is tokenized without special tokens.
"""

from __future__ import annotations

import re
from typing import List

from psalm_tpu_torch.data.constants import (
    CLS_TOKEN_INDEX,
    IMAGE_TOKEN_INDEX,
    REFER_TOKEN_INDEX,
    REGION_TOKEN_INDEX,
    SEG_TOKEN_INDEX,
)

_SPECIAL_MAP = {
    "<image>": IMAGE_TOKEN_INDEX,
    "<seg>": SEG_TOKEN_INDEX,
    "<cls>": CLS_TOKEN_INDEX,
    "<region>": REGION_TOKEN_INDEX,
    "<refer>": REFER_TOKEN_INDEX,
}
_SPLIT_RE = re.compile(r"(<image>|<seg>|<cls>|<region>|<refer>)")


def tokenize_special(prompt: str, tokenizer) -> List[int]:
    """Splice sentinel IDs between tokenized plain-text chunks."""
    ids: List[int] = []
    for chunk in _SPLIT_RE.split(prompt):
        if chunk in _SPECIAL_MAP:
            ids.append(_SPECIAL_MAP[chunk])
        elif chunk:
            ids.extend(tokenizer.encode(chunk, add_special_tokens=False))
    return ids
