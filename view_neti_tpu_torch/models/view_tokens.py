"""Host-side view-token parameter tables.

The reference view-mapper keeps Python dicts token_id -> camera params and
does per-sample dict lookups inside forward (reference
models/neti_mapper.py:208-337). Here the lookup is one tensor op on the
device, so this module precomputes, on the host:

  * a (V,) int32 array of view token ids,
  * a (V, C) float32 array of camera params already scaled to (-1, 1),

and the model does a vectorized id -> row match. Extension with novel view
tokens at inference (`add_view_tokens_to_vocab` semantics: never re-fit the
normalization bounds — reference models/neti_mapper.py:440-468) appends rows
scaled with the *stored* bounds.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from view_neti_tpu_torch.data import dtu
from view_neti_tpu_torch.utils.codec import string_to_num


def scale_m1_1(x: np.ndarray, xmin: np.ndarray, xmax: np.ndarray
               ) -> np.ndarray:
    """Scale to (-1, 1); dimensions with xmin == xmax pass through
    (reference models/neti_mapper.py:286-292)."""
    rng = xmax - xmin
    safe = np.where(rng == 0, 1.0, rng)
    scaled = (x - xmin) / safe * 2 - 1
    return np.where(rng == 0, x, scaled)


def _parse_spherical(token: str) -> List[float]:
    """<view_{theta}_{phi}_{r}> -> [theta, phi, r]."""
    return [string_to_num(n) for n in token[6:-1].split("_")]


@dataclass(frozen=True)
class ViewTokenTable:
    """Immutable view-token conditioning table.

    deg_freedom: 'phi' | 'theta-phi' | 'dtu-12d' — decides which camera
    columns condition the mapper (reference models/neti_mapper.py:250-256,
    542-564).
    """
    tokens: Tuple[str, ...]
    token_ids: np.ndarray          # (V,) int32
    params_raw: np.ndarray         # (V, C_raw) float32, unscaled
    mins: np.ndarray               # (C_raw,) normalization bounds
    maxs: np.ndarray
    deg_freedom: str

    @property
    def num_cond_dims(self) -> int:
        return num_cond_dims(self.deg_freedom)

    def params_scaled(self) -> np.ndarray:
        """(V, C_cond) conditioning columns scaled to (-1, 1)."""
        scaled = scale_m1_1(self.params_raw, self.mins, self.maxs)
        if self.deg_freedom == "phi":
            return scaled[:, 1:2]            # phi only
        if self.deg_freedom == "theta-phi":
            return scaled[:, 0:2]            # theta, phi
        return scaled                        # dtu-12d: all 12

    def extend(self, new_tokens: Sequence[str],
               new_token_ids: Sequence[int]) -> "ViewTokenTable":
        """Append novel view tokens WITHOUT re-fitting bounds
        (add_view_tokens_to_vocab parity)."""
        assert len(new_tokens) == len(new_token_ids)
        fresh = [(t, i) for t, i in zip(new_tokens, new_token_ids)
                 if t not in self.tokens]
        if not fresh:
            return self
        add_tokens = [t for t, _ in fresh]
        add_ids = [i for _, i in fresh]
        add_params = np.stack([_token_params(t, self.deg_freedom)
                               for t in add_tokens])
        return replace(
            self,
            tokens=self.tokens + tuple(add_tokens),
            token_ids=np.concatenate(
                [self.token_ids, np.asarray(add_ids, np.int32)]),
            params_raw=np.concatenate([self.params_raw, add_params], axis=0))


def num_cond_dims(deg_freedom: str) -> int:
    return {"phi": 1, "theta-phi": 2, "dtu-12d": 12}[deg_freedom]


def _token_params(token: str, deg_freedom: str) -> np.ndarray:
    if deg_freedom == "dtu-12d":
        params, _ = dtu.dtu_token_to_cam_params(token)
        return params.astype(np.float32)
    return np.asarray(_parse_spherical(token), dtype=np.float32)


def build_view_token_table(tokens: Sequence[str], token_ids: Sequence[int],
                           calibration_dir: Optional[str] = None
                           ) -> ViewTokenTable:
    """Construct the table with rescale_min_max=True semantics.

    DTU: normalization bounds come from *all* dataset cameras (not just the
    training views) so ranges stay stable when reusing pretrained mappers
    (reference models/neti_mapper.py:276-284). Spherical: bounds come from
    the given token set; deg_freedom is 'phi' when theta has no variation
    (reference models/neti_mapper.py:241-253).
    """
    assert len(tokens) == len(token_ids)
    tokens = list(tokens)
    if tokens and "dtu12d" in tokens[0]:
        deg_freedom = "dtu-12d"
        params = np.stack([_token_params(t, deg_freedom) for t in tokens])
        kwargs = {}
        if calibration_dir is not None:
            kwargs["calibration_dir"] = calibration_dir
        _, lookup = dtu.dtu_generate_dset_cam_tokens_params(**kwargs)
        mins, maxs = dtu.dtu_cam_bounds(lookup)
    else:
        assert all(t.startswith("<view_") for t in tokens), "not view tokens"
        params = np.stack([_token_params(t, "theta-phi") for t in tokens])
        mins, maxs = params.min(0), params.max(0)
        deg_freedom = "phi" if mins[0] == maxs[0] else "theta-phi"
    return ViewTokenTable(
        tokens=tuple(tokens),
        token_ids=np.asarray(token_ids, dtype=np.int32),
        params_raw=params.astype(np.float32),
        mins=mins.astype(np.float32),
        maxs=maxs.astype(np.float32),
        deg_freedom=deg_freedom)
