"""PromptManager: precompute the per-(timestep, UNet layer) text conditioning
(view_neti_tpu/inference/prompt_manager.py).

All (T, 16) pairs fold into batched CLIP forwards, chunked over T to bound
memory, and come back stacked as (T, 16, B, L, D) contexts that the denoise
loop indexes by step.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from view_neti_tpu_torch.training.text_forward import (TextModels,
                                                       neti_text_conditioning)
from view_neti_tpu_torch.utils.profiling import span


class PromptManager:
    def __init__(self, tokenizer, text_models: TextModels,
                 timesteps: Sequence[int],
                 placeholder_view_token_ids: Sequence[int] = (),
                 placeholder_object_token_ids: Sequence[int] = (),
                 dtype: torch.dtype = torch.float32):
        self.tokenizer = tokenizer
        self.text_models = text_models
        self.timesteps = np.asarray(timesteps)
        self.view_ids = np.asarray(list(placeholder_view_token_ids), np.int64)
        self.object_ids = np.asarray(list(placeholder_object_token_ids),
                                     np.int64)
        self.dtype = dtype

    @staticmethod
    def _extract_placeholder(ids: np.ndarray,
                             candidates: np.ndarray) -> np.ndarray:
        """(B,) id of the candidate present in each prompt, -1 if none."""
        out = np.full((ids.shape[0],), -1, np.int64)
        for b in range(ids.shape[0]):
            present = np.intersect1d(ids[b], candidates)
            if len(present) > 1:
                raise ValueError(
                    "at most one placeholder of each kind per prompt")
            if len(present):
                out[b] = present[0]
        return out

    def embed_prompt(self, text: str, truncation_idx: Optional[int] = None,
                     chunk: int = 10, object_idx: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(context, context_bypass), each (T, 16, 1, L, D)."""
        return self.embed_prompts([text], truncation_idx=truncation_idx,
                                  chunk=chunk, object_idx=object_idx)

    def embed_prompts(self, texts: Sequence[str],
                      truncation_idx: Optional[int] = None,
                      chunk: int = 10, object_idx: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(context, context_bypass), each (T, 16, B, L, D) for B prompts.
        A chunk of Tc timesteps runs as one CLIP batch of Tc*16*B rows.
        Spans (utils/profiling.span): "prompt.embed" the call,
        "prompt.tokenize", "prompt.chunk" a chunk's conditioning and
        "prompt.stack" the chunks' reshapes, concatenation and cast."""
        with span("prompt.embed"):
            return self._embed(texts, truncation_idx, chunk, object_idx)

    def _embed(self, texts, truncation_idx, chunk, object_idx):
        clip = self.text_models.clip
        device = clip.text_model.embeddings.token_embedding.weight.device
        L = clip.config.max_position_embeddings
        with span("prompt.tokenize"):
            ids = np.asarray(self.tokenizer(
                list(texts), padding="max_length", truncation=True,
                max_length=L).input_ids, np.int64)
            B = ids.shape[0]
            ph_obj = self._extract_placeholder(ids, self.object_ids)
            ph_view = self._extract_placeholder(ids, self.view_ids)

        def dev(a):
            return torch.as_tensor(a, device=device)

        chunks = []
        for s in range(0, len(self.timesteps), chunk):
            ts = self.timesteps[s:s + chunk]
            Tc = len(ts)
            with span("prompt.chunk"):
                chunks.append((Tc, *neti_text_conditioning(
                    self.text_models, dev(np.tile(ids, (Tc, 1))),
                    dev(np.tile(ph_obj, Tc)), dev(np.tile(ph_view, Tc)),
                    dev(np.repeat(ts, B).astype(np.float32)),
                    object_idx=object_idx, truncation_idx=truncation_idx)))
        with span("prompt.stack"):
            # (16, Tc*B, L, D) -> (Tc, 16, B, L, D)
            ctxs = [c.reshape(c.shape[0], Tc, B, L, -1).transpose(0, 1)
                    for Tc, c, _ in chunks]
            ctxbs = [cb.reshape(cb.shape[0], Tc, B, L, -1).transpose(0, 1)
                     for Tc, _, cb in chunks]
            return (torch.cat(ctxs).to(self.dtype),
                    torch.cat(ctxbs).to(self.dtype))
