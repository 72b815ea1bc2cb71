"""Tokenization: the sentinel splice and the task prompt builders.

Counterpart of ``psalm_tpu/data/tokenization.py``: the reference's
tokenizer_special_tokens regex splice (train_datasets.py:156-173, with the
RefCOCO variant's <refer>: the sentinels <image>, <seg>, <cls>, <region> and
<refer> become their negative ids, and the text between them is tokenized
without special tokens), the class-name token streams with the '[SEG]'
suffix (:175-186, :224), the preprocess_llama2 label masking (:91-154) and
the exact task prompt strings (:209-217, :339-345, :674-679).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np

from psalm_tpu_torch.data.constants import (
    CLS_TOKEN_INDEX,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    REFER_TOKEN_INDEX,
    REGION_TOKEN_INDEX,
    SEG_LITERAL_TOKEN,
    SEG_TOKEN_INDEX,
)
from psalm_tpu_torch.data.conversation import conv_llava_phi

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


def tokenize_class_names(class_names: Sequence[str], tokenizer,
                         cls_token: str = SEG_LITERAL_TOKEN
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class token stream with the [SEG] suffix
    (train_datasets.py:175-186). Returns (class_name_ids, cls_indices)."""
    suffix = tokenizer.encode(cls_token, add_special_tokens=False)[0]
    streams = [tokenizer.encode(n, add_special_tokens=False) + [suffix]
               for n in class_names]
    ids = [t for s in streams for t in s]
    idx = [i for i, s in enumerate(streams) for _ in s]
    return np.asarray(ids, np.int64), np.asarray(idx, np.int64)


def build_conversation(human: str, gpt: str) -> str:
    conv = conv_llava_phi.copy()
    conv.append_message(conv.roles[0], human)
    conv.append_message(conv.roles[1], gpt)
    return conv.get_prompt()


def tokenize_conversation(prompt: str, tokenizer,
                          mask_instruction: bool = True
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize an llava_phi-formatted conversation and produce labels with
    the reference's phi-specific masking (train_datasets.py:119-154):
    position 0 masked, each round's instruction (up to '[/INST] ', minus 2)
    masked.
    """
    input_ids = np.asarray(tokenize_special(prompt, tokenizer), np.int64)
    labels = input_ids.copy()
    if not mask_instruction:
        return input_ids, labels
    sep = "[/INST] "
    sep2 = conv_llava_phi.sep2
    rounds = prompt.split(sep2)

    # phi-version masking (train_datasets.py:846-871): the +1/+2 fudge terms
    # account for the '<|endoftext|>' separator tokens the per-round
    # tokenization doesn't see.
    cur = 0
    idx = 0
    for rou in rounds:
        if rou == "":
            continue
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        parts[0] += sep
        round_len = len(tokenize_special(rou, tokenizer)) + (2 if idx else 1)
        instruction_len = (len(tokenize_special(parts[0], tokenizer))
                           + (0 if idx else -1))
        labels[cur:cur + instruction_len] = IGNORE_INDEX
        cur += round_len
        idx += 1
    labels[cur:] = IGNORE_INDEX

    # data-quality guard (train_datasets.py:893-899): mismatch -> fully mask
    # with a warning. The reference's total_len counts all non-[PAD] tokens
    # (train.py adds a distinct [PAD]; none appear pre-collation), i.e. the
    # full token count — which the +1/+2 fudges make cur equal to when the
    # round tokenization is consistent.
    if cur != len(input_ids):
        import warnings
        warnings.warn(f"tokenization mismatch: {cur} vs {len(input_ids)} "
                      "(sample fully label-masked)")
        labels[:] = IGNORE_INDEX
    return input_ids, labels


# ---------------------------------------------------------------------------
# Exact task prompt strings (parity with train_datasets.py).


def panoptic_prompt(num_classes: int, task_name: str = "Panoptic Segmentation"
                    ) -> Tuple[str, str]:
    """train_datasets.py:209-217."""
    prefix = f"This is an image <image>, Please do {task_name}."
    category = "<cls>, " * (num_classes - 1) + "<cls>."
    human = prefix + f"\nThis is all the candidate categories: {category}\n"
    gpt = "\nSure, the segmentation result is <seg>"
    return human, gpt


def interactive_prompt(num_regions: int) -> Tuple[str, str]:
    """train_datasets.py:339-345."""
    prefix = "This is an image <image>, Please segment by given regions"
    regions = "<region>, " * (num_regions - 1) + "<region>."
    human = prefix + f"\nThis is all regions: {regions}\n"
    gpt = "\n[SEG]<seg>"
    return human, gpt


def referring_prompt() -> Tuple[str, str]:
    """train_datasets.py:674-679; the referring sentence itself is tokenized
    separately into token_refer_id with a [SEG] suffix (:619-625)."""
    human = ("This is an image <image>, Please doing Referring Segmentation "
             "according to the following instruction:\n<refer>")
    gpt = "\nSure, the segmentation result is <seg>"
    return human, gpt


def tokenize_referring_sentence(sentence: str, tokenizer) -> np.ndarray:
    suffix = tokenizer.encode(SEG_LITERAL_TOKEN, add_special_tokens=False)[0]
    ids = tokenizer.encode(sentence, add_special_tokens=False) + [suffix]
    return np.asarray(ids, np.int64)
