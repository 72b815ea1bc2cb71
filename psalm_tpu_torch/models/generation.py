"""Autoregressive generation for the chat/serve path.

Counterpart of ``psalm_tpu/models/generation.py``: one prefill over the
spliced multimodal sequence (Swin, projector, splice, Phi with a KV cache),
then single-token decode steps, sampled per row (temperature 0 = greedy),
``k`` steps per chunk with the tokens kept on the device and one host sync
per chunk (JAX's ``lax.scan`` chunk, here a Python loop of eager steps).

The KV cache keeps a position per row (``models/phi.py::KVCache``), so rows
of different valid lengths in one right-padded batch each decode exactly.
It is updated in place; JAX donates it to each chunk instead.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from psalm_tpu_torch.models.phi import KVCache

# the arrays of a spliced batch that the prefill reads
BATCH_KEYS = ("tok_ids", "src_type", "src_idx", "attention_mask", "images")
MAX_CHUNK = 128


class Generator:
    """Generation with ``model`` (a ``psalm_tpu_torch.models.psalm.PSALM``)
    on ``device``, with a KV cache of ``max_len`` slots in ``cache_dtype``.

    ``prefills`` and ``decode_steps`` count the model calls made, so that a
    caller can hold kernel launch counts against them."""

    def __init__(self, model, max_len: int = 2048,
                 cache_dtype=torch.bfloat16, device="cuda"):
        self.model = model
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = torch.device(device)
        self.prefills = 0
        self.decode_steps = 0

    @torch.no_grad()
    def prefill(self, batch: Dict[str, np.ndarray]
                ) -> Tuple[torch.Tensor, KVCache]:
        """The spliced batch -> (logits [B, V] at each row's last valid
        token, the filled cache with each row's position at its count of
        valid tokens)."""
        m = self.model
        tb = {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
              for k in BATCH_KEYS}
        _, image_tokens = m.encode_images(tb["images"])
        seq = m.assemble_embeddings(tb["tok_ids"], tb["src_type"],
                                    tb["src_idx"], image_tokens)
        B = seq.shape[0]
        cache = m.model.init_cache(B, self.max_len, self.cache_dtype)
        hidden = m.model(seq, attention_mask=tb["attention_mask"], cache=cache)
        last = hidden[torch.arange(B, device=hidden.device), cache.pos - 1]
        self.prefills += 1
        return m.lm_head(last), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """One token per row [B] at the rows' positions -> logits [B, V]."""
        m = self.model
        hidden = m.model(m.model.embed(tokens[:, None]), cache=cache)
        self.decode_steps += 1
        return m.lm_head(hidden[:, 0])

    @staticmethod
    def sample(logits: torch.Tensor, temperature: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
        """Per-row temperature [B]: 0 is greedy (argmax), above 0 a draw from
        softmax(logits / t) by the Gumbel-max trick with ``generator``."""
        greedy = logits.argmax(-1)
        t = temperature.clamp_min(1e-6)
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        drawn = (logits.float() / t[:, None] - torch.log(-torch.log(u))).argmax(-1)
        return torch.where(temperature > 0, drawn, greedy)

    @torch.no_grad()
    def decode_chunk(self, logits: torch.Tensor, cache: KVCache,
                     temperature: torch.Tensor, n_steps: int,
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample and decode ``n_steps`` tokens without a host sync: ->
        (tokens [B, n_steps] on the device, the last step's logits)."""
        toks = torch.empty(logits.shape[0], n_steps, dtype=torch.long,
                           device=logits.device)
        for j in range(n_steps):
            tok = self.sample(logits, temperature, generator)
            toks[:, j] = tok
            logits = self.decode(tok, cache)
        return toks, logits

    def generate(self, batch: Dict[str, np.ndarray], max_new_tokens: int = 128,
                 temperature=0.0, eos_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 stream: Optional[Callable[[np.ndarray], None]] = None,
                 chunk_size: int = 8) -> np.ndarray:
        """Tokens [B, T], T <= max_new_tokens. ``temperature`` is a scalar or
        one per row. chunk_size: tokens decoded per host sync, clamped to
        1..128. The stream callback receives one [B] array per token; once a
        row has emitted ``eos_id`` its later tokens are ``eos_id``, and the
        loop ends when every row has."""
        chunk_size = max(1, min(int(chunk_size), MAX_CHUNK))
        B, L = np.asarray(batch["tok_ids"]).shape
        if max_new_tokens <= 0:
            return np.zeros((B, 0), np.int64)
        if L + max_new_tokens > self.max_len:
            raise ValueError(f"{L} prompt + {max_new_tokens} new tokens exceed "
                             f"the KV cache of {self.max_len} slots")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        temp = torch.as_tensor(np.broadcast_to(
            np.asarray(temperature, np.float32), (B,)).copy()).to(self.device)
        logits, cache = self.prefill(batch)

        tokens: List[np.ndarray] = []
        done = np.zeros(B, bool)
        remaining = max_new_tokens
        while remaining > 0:
            k = min(chunk_size, remaining)
            chunk, logits = self.decode_chunk(logits, cache, temp, k, generator)
            chunk_np = chunk.cpu().numpy()  # the one sync of the chunk
            remaining -= k
            for j in range(k):
                tok_np = np.where(done, eos_id if eos_id is not None else 0,
                                  chunk_np[:, j])
                tokens.append(tok_np)
                if stream is not None:
                    stream(tok_np)
                if eos_id is not None:
                    done |= tok_np == eos_id
                    if done.all():
                        return np.stack(tokens, axis=1)
        return np.stack(tokens, axis=1)
