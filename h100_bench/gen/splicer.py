"""Static-shape token splicing (host side).

The benchmark's copy of the port's ``data/splicer.py`` (``splice``,
``stack_samples``, ``SplicedSample``): the traffic generators splice their
prompts with it, so the inputs are made without the program.

The reference splices multimodal embeddings with a per-sample Python chunk
loop on device (llava_phi.py:581-766) — the single biggest host-device
ping-pong in its hot path. TPU-first redesign: the data pipeline expands each
sentinel into its final positions *ahead of time*, emitting aligned arrays of
one static padded length; on device, sequence assembly is a handful of
vectorized gathers/selects (see models/psalm.py:assemble_embeddings).

Key observation enabling this: of the five sentinel kinds, three (<cls>
class-name tokens, <refer> sentence tokens, plain text) are ultimately plain
token embeddings (the reference embeds class_name_ids and refer ids with
embed_tokens — llava_phi.py:566-580), so they are emitted as TEXT with real
token ids. Only <image>, <seg>, <region> need non-text sources.

Emitted per sample (all length ``pad_len``):
  tok_ids   int32  token id at TEXT positions, 0 elsewhere
  src_type  int32  SRC_TEXT / SRC_IMAGE / SRC_SEG_QUERY / SRC_REGION / SRC_PAD
  src_idx   int32  index into the per-type source table (image token index,
                   seg query index, region index)
  attention_mask bool
  labels    int32  next-token labels (IGNORE_INDEX at non-text/pad)
  seg_query_mask           float  1 at seg-query positions
  class_name_embedding_indices int32  1..K at class-k name-token positions
  refer_embedding_indices  int32  1 at refer-token positions
  region_embedding_mask    float  1 at region-token positions
These reproduce the masks the reference builds on device
(llava_phi.py:627-746).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from h100_bench.reference.constants import (
    CLS_TOKEN_INDEX,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    REFER_TOKEN_INDEX,
    REGION_TOKEN_INDEX,
    SEG_TOKEN_INDEX,
    SRC_IMAGE,
    SRC_PAD,
    SRC_REGION,
    SRC_SEG_QUERY,
    SRC_TEXT,
)


@dataclasses.dataclass
class SplicedSample:
    tok_ids: np.ndarray
    src_type: np.ndarray
    src_idx: np.ndarray
    attention_mask: np.ndarray
    labels: np.ndarray
    seg_query_mask: np.ndarray
    class_name_embedding_indices: np.ndarray
    refer_embedding_indices: np.ndarray
    region_embedding_mask: np.ndarray
    length: int

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name != "length"}


def splice(
    input_ids: Sequence[int],
    labels: Optional[Sequence[int]] = None,
    *,
    num_image_tokens: int,
    num_seg_queries: int,
    pad_len: int,
    class_name_ids: Optional[np.ndarray] = None,
    cls_indices: Optional[np.ndarray] = None,
    token_refer_id: Optional[np.ndarray] = None,
    num_regions: int = 0,
    legacy_im_start_end: bool = False,
) -> SplicedSample:
    """Expand sentinels in ``input_ids`` into their final static positions.

    legacy_im_start_end: the LLaVA adapter-pretrain label quirk
    (llava_arch.py:106-118): with <im_start><image><im_end>, the label at the
    <image> sentinel position is re-attached to the <im_end> row (and
    <im_end>'s own label dropped) — the reference consumes
    ``cur_labels[image_token_start:image_token_start+1]`` after the image
    block and resumes at ``image_token_start+2``.
    """
    input_ids = np.asarray(input_ids, np.int64)
    if labels is not None:
        labels = np.asarray(labels, np.int64)
        assert labels.shape == input_ids.shape
        if legacy_im_start_end:
            labels = labels.copy()
            for p in np.where(input_ids == IMAGE_TOKEN_INDEX)[0]:
                if p + 1 < len(labels):
                    labels[p + 1] = labels[p]

    tok, styp, sidx, lab = [], [], [], []
    segm, clsm, refm, regm = [], [], [], []

    def emit(n, *, t=SRC_TEXT, ids=None, idx0=0, label_vals=None,
             seg=0.0, cls_id=0, refer=0, region=0.0):
        tok.extend(ids if ids is not None else [0] * n)
        styp.extend([t] * n)
        sidx.extend(range(idx0, idx0 + n) if t != SRC_TEXT else [0] * n)
        lab.extend(label_vals if label_vals is not None else [IGNORE_INDEX] * n)
        segm.extend([seg] * n)
        clsm.extend([cls_id] * n)
        refm.extend([refer] * n)
        regm.extend([region] * n)

    cls_idx = 0
    region_idx = 0
    for pos, tid in enumerate(input_ids):
        tid = int(tid)
        if tid == IMAGE_TOKEN_INDEX:
            emit(num_image_tokens, t=SRC_IMAGE)
        elif tid == SEG_TOKEN_INDEX:
            emit(num_seg_queries, t=SRC_SEG_QUERY, seg=1.0)
        elif tid == CLS_TOKEN_INDEX:
            assert class_name_ids is not None and cls_indices is not None
            ids_k = class_name_ids[cls_indices == cls_idx].tolist()
            cls_idx += 1
            emit(len(ids_k), ids=ids_k, cls_id=cls_idx)  # ids 1..K, llava_phi.py:666-674
        elif tid == REGION_TOKEN_INDEX:
            emit(1, t=SRC_REGION, idx0=region_idx, region=1.0)
            region_idx += 1
        elif tid == REFER_TOKEN_INDEX:
            assert token_refer_id is not None
            emit(len(token_refer_id), ids=list(token_refer_id), refer=1)
        else:
            emit(1, ids=[tid],
                 label_vals=[int(labels[pos])] if labels is not None else None)

    n = len(tok)
    if n > pad_len:
        raise ValueError(f"spliced length {n} exceeds pad_len {pad_len}")
    pad = pad_len - n
    emit(pad, t=SRC_PAD)

    if num_regions:
        assert region_idx == num_regions, (region_idx, num_regions)

    return SplicedSample(
        tok_ids=np.asarray(tok, np.int32).clip(min=0),
        src_type=np.asarray(styp, np.int32),
        src_idx=np.asarray(sidx, np.int32),
        attention_mask=np.asarray([True] * n + [False] * pad),
        labels=np.asarray(lab, np.int32),
        seg_query_mask=np.asarray(segm, np.float32),
        class_name_embedding_indices=np.asarray(clsm, np.int32),
        refer_embedding_indices=np.asarray(refm, np.int32),
        region_embedding_mask=np.asarray(regm, np.float32),
        length=n,
    )


def stack_samples(samples: Sequence[SplicedSample]) -> Dict[str, np.ndarray]:
    keys = samples[0].as_dict().keys()
    return {k: np.stack([s.as_dict()[k] for s in samples]) for k in keys}
