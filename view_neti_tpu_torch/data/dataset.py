"""TextualInversionDataset and DataLoader: the host side of training
(view_neti_tpu/data/dataset.py:52-580), on numpy and data/image_io.py.

Captions by mode:
  0: "a photo of a <object>" (a random IMAGENET template), on a folder
  1: "<view_x>. A photo of a {fixed_object}" (caption_strategy 1 and 2 too)
  2/4/5: "<view_x>. A photo of a <object>"
Modes 1-5 read DTU scans (camera_representation "dtu-12d"). Mode 3's
per-scene sampling and the spherical cameras of other datasets are later
modules of the port and raise.

Every stochastic choice of an example is keyed by (seed, epoch, index)
through numpy's default_rng, and the epoch order by (seed, epoch), so the
port's stream of captions, ids and image indices is the JAX package's,
bit for bit. The image path reads PNGs only (JPEG is a later module);
the deterministic preprocess is decode + resize, cached per file as uint8,
and the stochastic suffix runs on the card (ops/device_augment.py). The
host augmentation pipeline of the JAX package (data.device_augment false)
is a later module and raises.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from view_neti_tpu_torch.constants import IMAGENET_TEMPLATES_SMALL
from view_neti_tpu_torch.data import dtu as dtu_mod
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.utils.misc import filter_paths_imgs

# DTU preprocess keys: (width, height) of the resize; key 0 pads the
# 1600x1200 scan to 1600x1600 first (reference dataset.py:702-717)
DTU_SIZES = {-1: (64, 48), 0: (512, 512), 1: (512, 384), 2: (768, 576)}


class TextualInversionDataset:
    def __init__(self,
                 data_root: Union[str, Path],
                 tokenizer,
                 camera_representation: str,
                 learnable_mode: int,
                 fixed_object_token_or_path: Optional[str] = None,
                 size: int = 768,
                 repeats: int = 100,
                 flip_p: float = 0.0,
                 set_name: str = "train",
                 placeholder_object_token: str = "*",
                 dtu_lighting: str = "3",
                 dtu_subset: int = 0,
                 caption_strategy: int = 0,
                 dtu_preprocess_key: int = 0,
                 augmentation_key: int = 0,
                 center_crop: bool = False,
                 calibration_dir: Optional[str] = None,
                 seed: int = 0):
        if learnable_mode == 3:
            raise NotImplementedError(
                "mode 3 (per-scene sampling) is a later module of the port")
        if learnable_mode != 0 and camera_representation != "dtu-12d":
            raise NotImplementedError(
                f"camera_representation {camera_representation!r}: the "
                "port reads DTU cameras (dtu-12d)")
        self.learnable_mode = learnable_mode
        self.data_root = Path(data_root)
        self.tokenizer = tokenizer
        self.size = size
        self.placeholder_object_token = placeholder_object_token
        self.center_crop = center_crop
        self.flip_p = flip_p if learnable_mode == 0 else 0.0
        self.camera_representation = camera_representation
        self.dtu_lighting = str(dtu_lighting)
        self.dtu_subset = dtu_subset
        self.dtu_preprocess_key = dtu_preprocess_key
        self.caption_strategy = caption_strategy
        self.calibration_dir = calibration_dir
        self.seed = seed
        self._epoch = 0
        self.templates = IMAGENET_TEMPLATES_SMALL
        if self.caption_strategy > 0:
            assert learnable_mode == 1, \
                "alt caption_strategy only implemented for mode 1"

        paths = filter_paths_imgs(sorted(self.data_root.glob("*")))
        if learnable_mode != 0:
            paths = dtu_mod.dtu_filter_fnames_lighting(paths,
                                                       self.dtu_lighting)
            paths = dtu_mod.dtu_filter_image_paths_from_idx(
                paths, dtu_mod.dtu_get_train_idxs(dtu_subset))
        self.image_paths = paths
        self.image_paths_flattened = paths
        self.num_images = len(paths)
        assert self.num_images > 0, \
            "no images found; check data.train_data_dir"
        self._length = self.num_images * (repeats if set_name == "train"
                                          else 1)

        self._tok_cache: Dict[str, np.ndarray] = {}
        self._base_cache: Dict[str, np.ndarray] = {}
        self._base_cache_limit = int(os.environ.get(
            "VIEW_NETI_BASE_CACHE_MB", "512")) * 1_000_000
        self._base_cache_bytes = 0

        self.fixed_object_token_pretrained = False
        if learnable_mode == 0:
            self.placeholder_object_tokens = [placeholder_object_token]
            self.placeholder_view_tokens: List[str] = []
            self.fixed_object_token = None
        elif learnable_mode in (1, 2, 4, 5):
            self.placeholder_view_tokens = self._generate_view_tokens()
            if (fixed_object_token_or_path is not None
                    and str(fixed_object_token_or_path).endswith(
                        (".pt", ".msgpack"))):
                # a pretrained object mapper: its token comes from the cfg
                self.fixed_object_token_pretrained = True
                self.fixed_object_token = placeholder_object_token
                self.placeholder_object_tokens = [placeholder_object_token]
            elif learnable_mode == 1:
                self.fixed_object_token = fixed_object_token_or_path
                self.placeholder_object_tokens = []
            else:
                self.fixed_object_token = None
                self.placeholder_object_tokens = [placeholder_object_token]
        else:
            raise ValueError(f"learnable_mode {learnable_mode}")
        self.placeholder_tokens = (self.placeholder_view_tokens
                                   + self.placeholder_object_tokens)
        self.augmentation_key = augmentation_key

    # ---- view tokens (reference dataset.py:411-582) ----------------------
    def _generate_view_tokens(self) -> List[str]:
        """One token per camera of the scan, ordered by camera index."""
        kwargs = {}
        if self.calibration_dir is not None:
            kwargs["calibration_dir"] = self.calibration_dir
        (self.lookup_camidx_to_view_token,
         self.lookup_camidx_to_cam_params
         ) = dtu_mod.dtu_generate_dset_cam_tokens_params(**kwargs)
        cam_idxs = sorted(set(dtu_mod.dtu_cam_info_from_fname(f)[0]
                              for f in self.image_paths))
        return [self.lookup_camidx_to_view_token[k] for k in cam_idxs]

    def set_epoch(self, epoch: int) -> None:
        """The epoch mixed into each example's generator (set by the
        DataLoader)."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return self._length

    # ids and captions only, no image (the Coach sets it once the latent or
    # base cache on the card holds every image)
    skip_pixels: bool = False
    # emit the uint8 base image, for the augmentation on the card
    emit_base_pixels: bool = False

    def _preprocess_branch(self) -> str:
        """Which deterministic preprocess _base_image applies (keyed on the
        data root's name, reference dataset.py:692-737)."""
        root = str(self.data_root)
        if "dtu" in root:
            return "dtu"
        if "llff" in root:
            return "llff"
        return "square"

    @property
    def uniform_base_shape(self) -> bool:
        """True when every base image has one shape (the llff passthrough
        keeps each file's own)."""
        return self._preprocess_branch() != "llff"

    # ---- examples (reference dataset.py:605-739) -------------------------
    def __getitem__(self, i: int) -> Dict[str, Any]:
        placeholder_object_token = (self.placeholder_object_tokens[0]
                                    if self.placeholder_object_tokens
                                    else None)
        idx = i % self.num_images
        image_path = Path(self.image_paths[idx])
        example: Dict[str, Any] = {"image_idx": idx}
        ex_rng = np.random.default_rng((self.seed, self._epoch, int(i)))
        template = self.templates[int(ex_rng.integers(len(self.templates)))]

        if self.learnable_mode == 0:
            example["text"] = template.format(placeholder_object_token)
            example["input_ids_placeholder_view"] = np.int32(-1)
            example["input_ids_placeholder_object"] = np.int32(
                self.tokenizer.convert_tokens_to_ids(
                    placeholder_object_token))
        else:
            cam_key, _ = dtu_mod.dtu_cam_info_from_fname(image_path)
            view_token = self.lookup_camidx_to_view_token[cam_key]
            if self.learnable_mode == 1:
                obj = self.fixed_object_token
                if self.caption_strategy == 0:
                    text = f"{view_token}. A photo of a {obj}"
                elif self.caption_strategy == 1:
                    text = f"A photo of a {obj} in the stye of {view_token}"
                elif self.caption_strategy == 2:
                    text = f"A photo of a {obj} {view_token}"
                else:
                    raise NotImplementedError(self.caption_strategy)
                example["input_ids_placeholder_object"] = np.int32(
                    self.tokenizer.convert_tokens_to_ids(
                        placeholder_object_token)
                    if self.fixed_object_token_pretrained else -1)
            else:
                text = (f"{view_token}. A photo of a "
                        f"{placeholder_object_token}")
                example["input_ids_placeholder_object"] = np.int32(
                    self.tokenizer.convert_tokens_to_ids(
                        placeholder_object_token))
            example["text"] = text
            example["input_ids_placeholder_view"] = np.int32(
                self.tokenizer.convert_tokens_to_ids(view_token))

        # captions come from a small closed set: tokenize each once
        ids = self._tok_cache.get(example["text"])
        if ids is None:
            ids = np.asarray(self.tokenizer(
                example["text"], padding="max_length", truncation=True,
                max_length=self.tokenizer.model_max_length).input_ids[0])
            ids.setflags(write=False)
            self._tok_cache[example["text"]] = ids
        example["input_ids"] = ids
        example["object_idx"] = np.int32(0)

        if not self.skip_pixels:
            if self.emit_base_pixels:
                example["pixel_values"] = self._load_base(image_path)
            else:
                example["pixel_values"] = self._load_pixels(image_path,
                                                            ex_rng)
        return example

    def _load_base(self, image_path: Path) -> np.ndarray:
        """The uint8 decode + deterministic resize, cached per file up to
        VIEW_NETI_BASE_CACHE_MB."""
        key = str(image_path)
        base = self._base_cache.get(key)
        if base is None:
            base = self._base_image(image_io.read_rgb(image_path))
            if self._base_cache_bytes + base.nbytes \
                    <= self._base_cache_limit:
                self._base_cache[key] = base
                self._base_cache_bytes += base.nbytes
        return base

    def _load_pixels(self, image_path: Path,
                     rng: np.random.Generator) -> np.ndarray:
        """The base with the stochastic suffix on the host: the mode-0 flip
        and [-1, 1] scaling (NHWC float32)."""
        if self.augmentation_key > 0:
            raise NotImplementedError(
                "host augmentation (data.device_augment false) is a later "
                "module of the port; the augmentation runs on the card")
        img = self._load_base(image_path)
        if self.learnable_mode == 0 and rng.uniform() < self.flip_p:
            img = img[:, ::-1]
        return (np.asarray(img, np.uint8) / 127.5 - 1.0).astype(np.float32)

    def _base_image(self, img: np.ndarray) -> np.ndarray:
        """Deterministic preprocess: centre crop and the target resize."""
        if self.center_crop:
            h, w = img.shape[:2]
            crop = min(h, w)
            img = img[(h - crop) // 2:(h + crop) // 2,
                      (w - crop) // 2:(w + crop) // 2]
        branch = self._preprocess_branch()
        if branch == "dtu":
            if self.dtu_preprocess_key not in DTU_SIZES:
                raise NotImplementedError(self.dtu_preprocess_key)
            if self.dtu_preprocess_key == 0:
                img = np.pad(img, ((0, 400), (0, 0), (0, 0)))
                assert img.shape[:2] == (1600, 1600), img.shape
            return image_io.resize_u8(img, *DTU_SIZES[
                self.dtu_preprocess_key])
        if branch == "llff":
            return np.ascontiguousarray(img)
        return image_io.resize_u8(img, self.size, self.size)


class DataLoader:
    """Shuffling batcher with numpy collation (view_neti_tpu/data/
    dataset.py DataLoader, with shuffle and drop_last on). The epoch order
    is a function of (seed, epoch) and each example's draws of (seed,
    epoch, index), so the stream is a function of the batch position;
    start_batch fast-forwards to it."""

    def __init__(self, dataset: TextualInversionDataset, batch_size: int,
                 seed: int = 0, start_batch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self._next_batch = int(start_batch)

    @property
    def batches_per_epoch(self) -> int:
        """Whole batches of a shuffled epoch (the last partial one drops)."""
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        """One epoch, or the rest of one after a fast-forward."""
        n = len(self.dataset)
        bpe = self.batches_per_epoch
        epoch = self._next_batch // max(bpe, 1)
        first = self._next_batch % max(bpe, 1)
        order = np.random.default_rng((self.seed, epoch)).permutation(n)
        self.dataset.set_epoch(epoch)
        for b in range(first, bpe):
            start = b * self.batch_size
            examples = [self.dataset[int(i)]
                        for i in order[start:start + self.batch_size]]
            self._next_batch += 1
            yield self._collate(examples)

    @staticmethod
    def _collate(examples: List[Dict[str, Any]]) -> Dict[str, Any]:
        batch = {}
        keys = ("input_ids", "input_ids_placeholder_object",
                "input_ids_placeholder_view")
        if "pixel_values" in examples[0]:
            keys = ("pixel_values",) + keys
        for k in keys:
            batch[k] = np.stack([e[k] for e in examples])
        batch["object_idx"] = np.asarray(examples[0]["object_idx"])
        batch["image_idxs"] = np.asarray([e["image_idx"] for e in examples],
                                         np.int32)
        batch["texts"] = [e["text"] for e in examples]
        return batch
