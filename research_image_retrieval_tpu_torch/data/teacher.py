"""Offline text teacher for the distillation models (port of
``research_image_retrieval_tpu/data/teacher.py``, the port's own copy).

The distillation targets come from a closed text set (one description
per landmark class), so the teacher runs once on the host (torch on the
CPU) and gives a ``[num_classes, text_dim]`` table.  The train step
holds the table on its device and gathers rows by label
(``train/loop.make_train_step(teacher_table=...)``); the student-side
projections and the distillation terms are in ``models/sparse.py``
(``LLMKnowledgeDistillation``) and ``models/hamlet.py``
(``hamlet_loss``), which take the gathered rows as ``text_features``.

``transformers`` is imported inside ``TextTeacher``: a machine without
it raises ``ImportError`` there, and nowhere else.  Without cached
pretrained files, ``allow_random_init=True`` builds a random-init
DistilBERT of the same architecture from a seed plus a deterministic
hashing tokenizer (with a warning): texts still map to distinct,
deterministic embeddings, so every stage of the distillation path
(tokenize, encode, pool, table, gather, loss) runs, without semantic
knowledge.  Without it a missing model is a hard error.
"""

from __future__ import annotations

import warnings
import zlib
from typing import Sequence

import numpy as np

__all__ = ["TextTeacher", "default_label_texts", "load_label_texts"]


class _HashTokenizer:
    """Deterministic offline tokenizer: crc32(word) -> vocab id.

    Stands in for the pretrained WordPiece tokenizer when its vocab file
    is unavailable.  Ids are stable across processes/platforms (crc32,
    not Python ``hash``), distinct words collide only at the ~1/vocab
    level, and the [CLS] text [SEP] + pad layout matches what the
    DistilBERT encoder expects shape-wise.
    """

    def __init__(self, vocab_size: int, max_length: int):
        self.vocab_size = int(vocab_size)
        self.max_length = int(max_length)
        self.pad_id, self.cls_id, self.sep_id = 0, 1, 2
        self._reserved = 3

    def __call__(self, texts: Sequence[str]):
        n_words = self.max_length - 2
        ids = np.full((len(texts), self.max_length), self.pad_id, np.int64)
        mask = np.zeros((len(texts), self.max_length), np.int64)
        span = self.vocab_size - self._reserved
        for i, t in enumerate(texts):
            words = t.lower().split()[:n_words]
            row = [self.cls_id] + [
                self._reserved + zlib.crc32(w.encode()) % span for w in words
            ] + [self.sep_id]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask


class TextTeacher:
    """Frozen text encoder -> pooled fp32 embeddings, host-side, run once.

    Args:
      model_name: hub name tried first (pretrained weights + tokenizer,
        local files only: the teacher never downloads).
      max_length: token truncation length (reference uses 128,
        ``sparse_model.py:82``; landmark label texts are short).
      seed: torch seed for the random-init fallback (determinism).
      config_overrides: DistilBertConfig overrides for the fallback
        (e.g. ``dict(n_layers=1, dim=32, hidden_dim=64, n_heads=2)``
        keeps tests fast); ignored when pretrained weights load.
      allow_random_init: opt-in for the random-init fallback.  Without
        it a missing/typo'd ``model_name`` (or corrupted hub cache) is a
        HARD ERROR instead of a warning — a random teacher trains with
        semantically meaningless distillation targets that are easy to
        miss in logs.  ``cli.train --teacher-allow-random`` sets it.
    """

    def __init__(self, model_name: str = "distilbert-base-uncased",
                 max_length: int = 64, seed: int = 0,
                 config_overrides: dict | None = None,
                 allow_random_init: bool = False):
        import os

        # hard-offline: even with local_files_only=True, hub code paths
        # (e.g. the PEFT adapter_config probe) issue HEAD requests and
        # burn minutes in DNS retries on a machine without a network
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        import torch
        from transformers import AutoModel, AutoTokenizer, DistilBertConfig
        from transformers import DistilBertModel

        self.model_name = model_name
        self.max_length = int(max_length)
        self._torch = torch
        self.pretrained = False
        try:  # pretrained path: weights + matching tokenizer or nothing
            self._model = AutoModel.from_pretrained(
                model_name, local_files_only=True)
            self._tokenizer = AutoTokenizer.from_pretrained(
                model_name, local_files_only=True)
            self.pretrained = True
        except Exception as e:
            if not allow_random_init:
                raise RuntimeError(
                    f"TextTeacher: could not load pretrained "
                    f"'{model_name}' from the local hub cache "
                    f"({type(e).__name__}: {e}). Check the model name / "
                    "cache, or pass allow_random_init=True "
                    "(--teacher-allow-random) to knowingly distill from a "
                    "RANDOM-INIT teacher."
                ) from e
            cfg = DistilBertConfig(**(config_overrides or {}))
            torch.manual_seed(seed)
            self._model = DistilBertModel(cfg)
            self._tokenizer = _HashTokenizer(cfg.vocab_size, self.max_length)
            warnings.warn(
                f"TextTeacher: no local pretrained '{model_name}' — using a "
                "RANDOM-INIT DistilBERT + hashing tokenizer (deterministic, "
                "exercises the full distillation path, carries no semantic "
                "knowledge). Provide cached hub files for real distillation.",
                stacklevel=2)
        self._model.eval()
        for p in self._model.parameters():
            p.requires_grad_(False)
        self.text_dim = int(self._model.config.dim
                            if hasattr(self._model.config, "dim")
                            else self._model.config.hidden_size)

    def _tokenize(self, texts: Sequence[str]):
        if self.pretrained:
            enc = self._tokenizer(list(texts), padding=True, truncation=True,
                                  max_length=self.max_length,
                                  return_tensors="pt")
            return enc["input_ids"], enc["attention_mask"]
        ids, mask = self._tokenizer(texts)
        return self._torch.as_tensor(ids), self._torch.as_tensor(mask)

    def encode(self, texts: Sequence[str], batch_size: int = 256) -> np.ndarray:
        """``[B]`` texts -> ``[B, text_dim]`` fp32, attention-mask-aware
        mean pooling over ``last_hidden_state`` (the reference mean-pools
        the same tensor, ``sparse_model.py:124-126``)."""
        torch = self._torch
        outs = []
        with torch.no_grad():
            for s in range(0, len(texts), batch_size):
                ids, mask = self._tokenize(texts[s:s + batch_size])
                h = self._model(input_ids=ids,
                                attention_mask=mask).last_hidden_state
                m = mask[..., None].to(h.dtype)
                pooled = (h * m).sum(1) / m.sum(1).clamp(min=1.0)
                outs.append(pooled.float().numpy())
        return np.concatenate(outs, axis=0)

    def class_table(self, label_texts: Sequence[str],
                    batch_size: int = 256) -> np.ndarray:
        """One embedding per class: ``[num_classes, text_dim]`` fp32 —
        the device-resident distillation table for
        ``make_train_step(teacher_table=...)``."""
        return self.encode(list(label_texts), batch_size=batch_size)


def default_label_texts(num_classes: int,
                        template: str = "a photo of landmark {}") -> list:
    """Synthetic per-class texts for datasets with integer labels only
    (GLDv2-clean's train CSV carries no class names)."""
    return [template.format(i) for i in range(num_classes)]


def load_label_texts(path: str, num_classes: int | None = None) -> list:
    """One text per line, line i = class i; optionally checked against
    ``num_classes``."""
    with open(path) as f:
        texts = [ln.strip() for ln in f if ln.strip()]
    if num_classes is not None and len(texts) != num_classes:
        raise ValueError(
            f"{path} has {len(texts)} label texts, expected {num_classes}")
    return texts
