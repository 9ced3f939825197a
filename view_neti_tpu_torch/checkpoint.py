"""Checkpoint files: learned embeddings, mapper states and the config
(view_neti_tpu/checkpoint.py:39-190).

The port writes the JAX package's files, in its tree layout, through its
own msgpack codec (utils/msgpack_codec.py), so each side reads the other's:

  learned_embeds-steps-N.msgpack : {token: (D,) float32 row}
  mapper-steps-N_object.msgpack  : {"cfg": <encoded RunConfig>,
                                    "mappers": {token: {
                                       "params": <JAX mapper tree>,
                                       "constants": <its frequency matrix>,
                                       "placeholder_object_token": str}}}
  mapper-steps-N_view.msgpack    : the same for the view mapper ("view"),
                                    plus "view_tokens", "view_token_ids"
                                    and "view_table" (the camera bounds)

and the -final variants. The trees are numpy; weight_port.to_jax_trainable
and from_jax_mapper convert to and from the port's mappers. The resumable
train state (the JAX package's orbax state) is train_state.py's.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from view_neti_tpu_torch import config as config_lib
from view_neti_tpu_torch.models.view_tokens import ViewTokenTable
from view_neti_tpu_torch.utils import msgpack_codec


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class CheckpointHandler:
    def __init__(self, cfg, placeholder_view_tokens: List[str],
                 placeholder_view_token_ids: List[int],
                 placeholder_object_tokens: List[str],
                 placeholder_object_token_ids: List[int],
                 save_root: Path):
        self.cfg = cfg
        self.placeholder_view_tokens = placeholder_view_tokens
        self.placeholder_view_token_ids = placeholder_view_token_ids
        self.placeholder_object_tokens = placeholder_object_tokens
        self.placeholder_object_token_ids = placeholder_object_token_ids
        # created by the first save: under data parallelism only rank 0
        # saves, and the other ranks create nothing
        self.save_root = Path(save_root)

    def save_learned_embeds(self, token_table: np.ndarray,
                            save_name: str) -> Path:
        tokens = (self.placeholder_view_tokens
                  + self.placeholder_object_tokens)
        ids = (self.placeholder_view_token_ids
               + self.placeholder_object_token_ids)
        payload = {t: np.asarray(token_table[i], np.float32)
                   for t, i in zip(tokens, ids)}
        self.save_root.mkdir(parents=True, exist_ok=True)
        path = self.save_root / save_name
        path.write_bytes(msgpack_codec.packb(payload))
        return path

    def save_mapper(self, trainable: Dict[str, Any], obj_constants: Any,
                    view_constants: Any,
                    view_table: Optional[ViewTokenTable],
                    save_name: str) -> List[Path]:
        """Writes mapper-..._object.msgpack and/or _view.msgpack from the
        JAX-layout trainable tree {"object": bank, "view": params}."""
        cfg_enc = config_lib.encode(self.cfg)
        self.save_root.mkdir(parents=True, exist_ok=True)
        paths = []
        if trainable.get("object") is not None:
            bank = trainable["object"]
            mappers = {
                tok: {"params": _tree_map(lambda a, i=i: np.asarray(a)[i],
                                          bank),
                      "constants": obj_constants,
                      "placeholder_object_token": tok}
                for i, tok in enumerate(self.placeholder_object_tokens)}
            p = self.save_root / save_name.replace(".msgpack",
                                                   "_object.msgpack")
            p.write_bytes(msgpack_codec.packb({"cfg": cfg_enc,
                                               "mappers": mappers}))
            paths.append(p)
        if trainable.get("view") is not None:
            payload = {
                "cfg": cfg_enc,
                "mappers": {"view": {
                    "params": trainable["view"],
                    "constants": view_constants,
                    "placeholder_object_token": "",
                }},
                "view_tokens": list(self.placeholder_view_tokens),
                "view_token_ids": [int(i) for i in
                                   self.placeholder_view_token_ids],
            }
            if view_table is not None:
                payload["view_table"] = {
                    "mins": np.asarray(view_table.mins),
                    "maxs": np.asarray(view_table.maxs),
                    "deg_freedom": view_table.deg_freedom,
                    "params_raw": np.asarray(view_table.params_raw),
                }
            p = self.save_root / save_name.replace(".msgpack",
                                                   "_view.msgpack")
            p.write_bytes(msgpack_codec.packb(payload))
            paths.append(p)
        return paths

    def save_model(self, trainable, obj_constants, view_constants,
                   view_table, token_table, embeds_save_name: str,
                   mapper_save_name: str) -> None:
        """Both artifacts, as the reference's save_model."""
        self.save_learned_embeds(np.asarray(token_table), embeds_save_name)
        self.save_mapper(trainable, obj_constants, view_constants,
                         view_table, mapper_save_name)

    @staticmethod
    def load_raw(path: Path) -> Dict[str, Any]:
        return msgpack_codec.unpackb(Path(path).read_bytes())

    @staticmethod
    def load_mapper(path: Path) -> Tuple[Any, Dict[str, Any]]:
        """(the decoded RunConfig, the payload), with the config's
        runtime-only keys stripped before decoding."""
        payload = CheckpointHandler.load_raw(path)
        cfg = config_lib.decode(config_lib.RunConfig,
                                clean_config_dict(payload["cfg"]))
        return cfg, payload

    @staticmethod
    def load_learned_embeds(path: Path) -> Dict[str, np.ndarray]:
        return CheckpointHandler.load_raw(path)

    @staticmethod
    def restore_view_table(payload: Dict[str, Any]) -> ViewTokenTable:
        vt = payload["view_table"]
        return ViewTokenTable(
            tokens=tuple(payload["view_tokens"]),
            token_ids=np.asarray(payload["view_token_ids"], np.int32),
            params_raw=np.asarray(vt["params_raw"], np.float32),
            mins=np.asarray(vt["mins"], np.float32),
            maxs=np.asarray(vt["maxs"], np.float32),
            deg_freedom=str(vt["deg_freedom"]))


def clean_config_dict(cfg_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Drop the runtime-computed keys and the nulls, so that a saved
    config decodes (reference checkpoint_handler.py:99-127)."""
    out = {}
    runtime_keys = {"placeholder_view_tokens", "target_norm_object",
                    "target_norm_view"}
    for k, v in cfg_dict.items():
        if k in runtime_keys or v is None:
            continue
        out[k] = clean_config_dict(v) if isinstance(v, dict) else v
    return out


def apply_learned_embeds_to_table(token_table: np.ndarray,
                                  embeds: Dict[str, np.ndarray],
                                  tokenizer) -> Tuple[np.ndarray, List[int]]:
    """Add each token of `embeds` (load_learned_embeds's dict) to the
    tokenizer and write its row into a copy of the word-embedding table;
    returns (the table, the tokens' ids in the dict's order). Raises
    ValueError where an id falls outside the table
    (view_neti_tpu/checkpoint.py:174-190; the reference's
    load_learned_embed_in_clip)."""
    table = np.array(token_table)
    ids = []
    for token, row in embeds.items():
        tokenizer.add_tokens([token])
        tid = tokenizer.convert_tokens_to_ids(token)
        if tid >= table.shape[0]:
            raise ValueError(f"vocab overflow loading {token}: id {tid} >= "
                             f"{table.shape[0]}")
        table[tid] = np.asarray(row, np.float32)
        ids.append(tid)
    return table, ids
