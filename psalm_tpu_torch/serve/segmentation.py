"""Segmentation over HTTP: the eval runner behind the worker's
``/worker_segment`` route.

Counterpart of ``psalm_tpu/serve/segmentation.py``. A client POSTs an image
and gets masks back as COCO RLEs, restored to the image's own size:

  panoptic  - COCO-panoptic segmentation (class-name conditioning);
  semantic  - the argmax semantic map, one RLE per class present;
  referring - the best mask for a free-form expression ([SEG]).

Each task keeps its own ``EvalRunner`` (``eval/runner.py``) on the shared
model. Prompts are padded to ``max_length`` (2048), as JAX pads them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from psalm_tpu_torch.config import PSALMConfig, SegTask
from psalm_tpu_torch.data import coco_rle
from psalm_tpu_torch.data.datasets import COCO_CLASS_NAMES, DataConfig, collate
from psalm_tpu_torch.data.mappers import ImageMapper
from psalm_tpu_torch.data.splicer import splice
from psalm_tpu_torch.data.tokenization import (build_conversation,
                                               panoptic_prompt,
                                               referring_prompt,
                                               tokenize_class_names,
                                               tokenize_conversation,
                                               tokenize_referring_sentence)
from psalm_tpu_torch.eval.runner import EvalRunner


class SegmentService:
    def __init__(self, model, tokenizer, cfg: PSALMConfig,
                 class_names: Optional[Sequence[str]] = None,
                 is_thing: Optional[Sequence[bool]] = None,
                 max_length: int = 2048):
        self.model = model
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.class_names = (list(class_names) if class_names
                            else COCO_CLASS_NAMES + ["background"])
        self.is_thing = (list(is_thing) if is_thing is not None
                         else [True] * (len(self.class_names) - 1))
        self.data_cfg = DataConfig(
            image_size=cfg.image_size,
            num_image_tokens=(cfg.image_size // 64) ** 2,
            num_seg_queries=cfg.mask_decoder.num_queries,
            pad_len=max_length)
        self.mapper = ImageMapper(cfg.image_size, device_normalize=True)
        self._runners: Dict[SegTask, Any] = {}

    # -- internals -----------------------------------------------------------

    def _runner(self, task: SegTask):
        if task not in self._runners:
            cfg = dataclasses.replace(self.cfg, seg_task=task)
            self._runners[task] = EvalRunner(
                self.model, cfg, num_class_names=len(self.class_names),
                is_thing=self.is_thing)
        return self._runners[task]

    def _splice(self, input_ids, **kw):
        return splice(input_ids, None,
                      num_image_tokens=self.data_cfg.num_image_tokens,
                      num_seg_queries=self.data_cfg.num_seg_queries,
                      pad_len=self.data_cfg.pad_len, **kw)

    def _base_sample(self, image: np.ndarray, dataset_type: str):
        proc = self.mapper.transform_image(image)
        return proc, {"images": proc.image, "padding_mask": proc.padding_mask,
                      "resized_hw": np.asarray(proc.resized_hw),
                      "original_hw": np.asarray(proc.original_hw),
                      "dataset_type": dataset_type}

    def _class_name_sample(self, image: np.ndarray, task_name: str,
                           dataset_type: str):
        proc, base = self._base_sample(image, dataset_type)
        human, gpt = panoptic_prompt(len(self.class_names),
                                     task_name=task_name)
        input_ids, _ = tokenize_conversation(
            build_conversation(human, gpt), self.tokenizer)
        cls_ids, cls_idx = tokenize_class_names(self.class_names,
                                                self.tokenizer)
        s = self._splice(input_ids, class_name_ids=cls_ids,
                         cls_indices=cls_idx)
        return proc, collate([{**s.as_dict(), **base}])

    # -- public API ----------------------------------------------------------

    def panoptic(self, image: np.ndarray) -> Dict[str, Any]:
        """{"segments": [{id, category_id, category, isthing, rle}],
        "height", "width"} in the original image geometry."""
        proc, batch = self._class_name_sample(
            image, "Panoptic Segmentation", "panoptic_coco")
        out = self._runner(SegTask.PANOPTIC).infer(batch)
        pan = np.asarray(out["panoptic_seg"][0], np.int32)
        info = {k: np.asarray(v[0]) for k, v in out["segments"].items()}
        segments: List[Dict[str, Any]] = []
        for q in np.nonzero(info["valid"])[0]:
            sid = int(info["id"][q])
            m = pan == sid
            if not m.any():
                continue
            cat = int(info["category"][q])
            segments.append({
                "id": sid, "category_id": cat,
                "category": self.class_names[cat],
                "isthing": bool(info["isthing"][q]),
                "rle": _jsonable_rle(coco_rle.encode(m)),
            })
        return {"segments": segments, "height": int(proc.original_hw[0]),
                "width": int(proc.original_hw[1])}

    def semantic(self, image: np.ndarray) -> Dict[str, Any]:
        """{"classes": [{category_id, category, rle}], "height", "width"}
        for every class present in the argmax semantic map."""
        proc, batch = self._class_name_sample(
            image, "Semantic Segmentation", "semantic_coco")
        out = self._runner(SegTask.SEMANTIC).infer(batch)
        sem = np.asarray(out["sem_seg"][0], np.int32)
        classes = []
        for c in np.unique(sem):
            c = int(c)
            if c >= len(self.class_names) - 1:
                continue
            classes.append({"category_id": c,
                            "category": self.class_names[c],
                            "rle": _jsonable_rle(coco_rle.encode(sem == c))})
        return {"classes": classes, "height": int(proc.original_hw[0]),
                "width": int(proc.original_hw[1])}

    def referring(self, image: np.ndarray, expression: str) -> Dict[str, Any]:
        """The best mask for a free-form expression: {"rle", "score",
        "height", "width"}."""
        proc, base = self._base_sample(image, "referring_coco")
        human, gpt = referring_prompt()
        input_ids, _ = tokenize_conversation(
            build_conversation(human, gpt), self.tokenizer)
        refer_ids = tokenize_referring_sentence(" " + expression.strip()
                                                + ".", self.tokenizer)
        s = self._splice(input_ids, token_refer_id=refer_ids)
        batch = collate([{**s.as_dict(), **base}])
        out = self._runner(SegTask.REFERRING).infer(batch)
        ref = {k: np.asarray(v[0]) for k, v in out["referring"].items()}
        best = int(np.argmax(ref["scores"]))
        mask = np.asarray(ref["masks"][best])
        return {"rle": _jsonable_rle(coco_rle.encode(mask.astype(bool))),
                "score": float(ref["scores"][best]),
                "height": int(proc.original_hw[0]),
                "width": int(proc.original_hw[1])}

    def segment(self, image: np.ndarray, task: str, **kw) -> Dict[str, Any]:
        if task == "panoptic":
            return self.panoptic(image)
        if task == "semantic":
            return self.semantic(image)
        if task == "referring":
            expr = kw.get("expression")
            if not expr:
                raise ValueError("referring task requires 'expression'")
            return self.referring(image, expr)
        raise ValueError(f"unknown segmentation task {task!r}; expected "
                         "panoptic | semantic | referring")


def _jsonable_rle(rle: Dict) -> Dict:
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    return {"size": [int(s) for s in rle["size"]], "counts": counts}
