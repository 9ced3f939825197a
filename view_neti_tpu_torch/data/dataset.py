"""TextualInversionDataset and DataLoader: the host side of training
(view_neti_tpu/data/dataset.py:52-580), on numpy and data/image_io.py.

Captions by mode:
  0: "a photo of a <object>" (a random IMAGENET template), on a folder
  1: "<view_x>. A photo of a {fixed_object}" (caption_strategy 1 and 2 too)
  2/4/5: "<view_x>. A photo of a <object>"
  3: "<view_x>. A photo of a <object_y>", one DTU scan per object token
     (train_data_subsets), the scan resampled per batch or per group
View tokens: DTU scans (camera_representation "dtu-12d") take one token
per camera from the calibration; other datasets ("spherical", modes 1
and 2) take <view_{theta}_{phi}_{r}> from each file's stem after its last
"___", sorted, and ordered by phi when only phi varies. Modes 3-5 are
DTU-only, as in the JAX package.

Every stochastic choice of an example is keyed by (seed, epoch, index)
through numpy's default_rng, the epoch order by (seed, epoch) and mode 3's
scene by (seed, batch or group counter), so the port's stream of captions,
ids and image indices is the JAX package's, bit for bit. Images are PNGs
or JPEGs (image_io.read_rgb); the deterministic preprocess is decode +
resize (or, for a data root whose path holds "llff", the decoded image as
it is), cached per file as uint8. The stochastic suffix runs on the card
(ops/device_augment.py) or, when the Coach has no augmentation there, here:
the mode-0 flip and the preset's host pipeline (data/augment.py), drawn
from the example's generator in the JAX package's order.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from view_neti_tpu_torch.constants import IMAGENET_TEMPLATES_SMALL
from view_neti_tpu_torch.data import dtu as dtu_mod
from view_neti_tpu_torch.data import image_io
from view_neti_tpu_torch.data.augment import (AUGMENTATION_PRESETS,
                                              apply_augmentations,
                                              build_augmentations)
from view_neti_tpu_torch.utils.codec import string_to_num
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
                 train_data_subsets: Optional[Sequence[Path]] = None,
                 placeholder_object_tokens: Optional[List[str]] = None,
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
        if learnable_mode in (3, 4, 5) and camera_representation != "dtu-12d":
            raise ValueError(f"mode {learnable_mode} runs on DTU scans "
                             "only (camera_representation dtu-12d)")
        if (learnable_mode == 3 and fixed_object_token_or_path is not None
                and str(fixed_object_token_or_path).endswith(
                    (".pt", ".msgpack"))):
            # the JAX dataset takes the mapper's one token here and then
            # cannot name a scan's token: its first example raises
            raise ValueError(
                f"data.fixed_object_token_or_path "
                f"{fixed_object_token_or_path!r}: a pretrained object mapper "
                f"is for modes 1 and 2; mode 3 trains one object mapper per "
                f"scan of data.train_data_subsets")
        self.learnable_mode = learnable_mode
        self.data_root = Path(data_root)
        self.tokenizer = tokenizer
        self.size = size
        self.placeholder_object_token = placeholder_object_token
        self.center_crop = center_crop
        self.flip_p = flip_p if learnable_mode == 0 else 0.0
        self.train_data_subsets = ([str(x) for x in train_data_subsets]
                                   if train_data_subsets else None)
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

        if learnable_mode != 3:
            paths = self._scan_paths(self.data_root)
            self.image_paths = paths
            self.image_paths_flattened = paths
        else:
            # one scan per subset; image_idx is global over the flattened
            # list (each subset's offset added), so that a cache built over
            # image_paths_flattened can be indexed by it
            self.image_paths = {}
            self._subset_offsets = {}
            flat = []
            for sub in self.train_data_subsets:
                paths = self._scan_paths(self.data_root / sub)
                assert paths, f"no images in subset {sub}"
                self.image_paths[sub] = paths
                self._subset_offsets[sub] = len(flat)
                flat += paths
            self.image_paths_flattened = flat
            self.reset_sampled_object(0)
        self.num_images = len(self.image_paths_flattened)
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
        elif learnable_mode in (1, 2, 3, 4, 5):
            self.placeholder_view_tokens = self._order_view_tokens(
                self._generate_view_tokens())
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
            elif learnable_mode == 3:
                self.fixed_object_token = None
                self.placeholder_object_tokens = list(
                    placeholder_object_tokens)
                self.lookup_object_to_placeholder_object_token = dict(
                    zip(self.train_data_subsets,
                        self.placeholder_object_tokens))
            else:
                self.fixed_object_token = None
                self.placeholder_object_tokens = [placeholder_object_token]
        else:
            raise ValueError(f"learnable_mode {learnable_mode}")
        self.placeholder_tokens = (self.placeholder_view_tokens
                                   + self.placeholder_object_tokens)
        self.augmentation_key = augmentation_key
        # the host pipeline, for the Coach without augmentation on the card;
        # its crop's (h, w) as the JAX package sizes it: mode 0 the
        # resolution, DTU keys 0 and 1 their own size, any other 576x768
        self.augmentations = None
        if augmentation_key > 0:
            if learnable_mode == 0:
                aug_size = (size, size)
            else:
                w, h = DTU_SIZES[dtu_preprocess_key if dtu_preprocess_key
                                 in (0, 1) else 2]
                aug_size = (h, w)
            self.augmentations = build_augmentations(augmentation_key,
                                                     aug_size)

    def _scan_paths(self, root: Path) -> List[Path]:
        """The folder's images; DTU runs keep the lighting and the cameras
        of dtu_subset."""
        paths = filter_paths_imgs(sorted(Path(root).glob("*")))
        if (self.camera_representation == "dtu-12d"
                and self.learnable_mode != 0):
            paths = dtu_mod.dtu_filter_fnames_lighting(paths,
                                                       self.dtu_lighting)
            paths = dtu_mod.dtu_filter_image_paths_from_idx(
                paths, dtu_mod.dtu_get_train_idxs(self.dtu_subset))
        return paths

    # ---- view tokens (reference dataset.py:411-582) ----------------------
    def _generate_view_tokens(self) -> List[str]:
        """DTU: one token per camera of the scan, ordered by camera index.
        Spherical: <view_{stem after its last "___"}>, sorted."""
        if self.camera_representation == "spherical":
            prefixes = [Path(f).stem.split("___")[-1]
                        for f in self.image_paths_flattened]
            bad = [p for p in prefixes if len(p.split("_")) != 3]
            if bad:
                raise ValueError(
                    f"spherical image names end in ___<theta>_<phi>_<r>; "
                    f"got {bad[:3]}")
            return sorted(set(f"<view_{p}>" for p in prefixes))
        if self.camera_representation != "dtu-12d":
            raise ValueError(f"camera_representation "
                             f"{self.camera_representation!r}")
        kwargs = {}
        if self.calibration_dir is not None:
            kwargs["calibration_dir"] = self.calibration_dir
        (self.lookup_camidx_to_view_token,
         self.lookup_camidx_to_cam_params
         ) = dtu_mod.dtu_generate_dset_cam_tokens_params(**kwargs)
        cam_idxs = sorted(set(dtu_mod.dtu_cam_info_from_fname(f)[0]
                              for f in self.image_paths_flattened))
        return [self.lookup_camidx_to_view_token[k] for k in cam_idxs]

    def _order_view_tokens(self, tokens: List[str]) -> List[str]:
        """The validation sweeps' order (reference dataset.py:524-582):
        DTU tokens are already in camera order; spherical ones are sorted
        by phi when only phi varies, else kept."""
        if self.camera_representation == "dtu-12d":
            return tokens
        params = np.asarray([[string_to_num(n) for n in t[6:-1].split("_")]
                             for t in tokens])
        n_uniques = [len(np.unique(params[:, i])) for i in range(3)]
        if n_uniques[0] == 1 and n_uniques[1] > 1 and n_uniques[2] == 1:
            return [tokens[i] for i in np.argsort(params[:, 1])]
        return tokens

    def reset_sampled_object(self, counter: int) -> None:
        """Mode 3: draw the scene of the next examples. counter is the
        draw's index (the DataLoader passes its global batch or group
        counter), so the scene sequence depends on the position alone."""
        assert self.learnable_mode == 3
        rng = np.random.default_rng((self.seed, 0x5CE4E, int(counter)))
        self.current_object_idx = int(
            rng.integers(len(self.train_data_subsets)))

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

    def check_host_batches(self) -> None:
        """Raise unless the host pipeline's images can be stacked: the
        llff passthrough keeps each file's size, so a folder of several
        sizes needs a preset that crops to one."""
        if self.uniform_base_shape or (
                self.augmentations is not None and "crop_scale"
                in AUGMENTATION_PRESETS[self.augmentation_key]):
            return
        sizes = set()
        for p in self.image_paths_flattened:
            h, w = image_io.image_size(p)
            sizes.add((min(h, w),) * 2 if self.center_crop else (h, w))
        if len(sizes) > 1:
            raise ValueError(
                f"{self.data_root}: the llff passthrough keeps each image's "
                f"size and the folder holds {len(sizes)} sizes "
                f"{sorted(sizes)[:4]}; its batches cannot be stacked. Use "
                "an augmentation_key whose preset crops ("
                + ", ".join(str(k) for k, p in AUGMENTATION_PRESETS.items()
                            if "crop_scale" in p)
                + "), data.center_crop on images of one short side, or "
                "images of one size")

    @property
    def uniform_base_shape(self) -> bool:
        """True when every base image has one shape (the llff passthrough
        keeps each file's own)."""
        return self._preprocess_branch() != "llff"

    # ---- examples (reference dataset.py:605-739) -------------------------
    def __getitem__(self, i: int) -> Dict[str, Any]:
        if self.learnable_mode == 3:
            scene = self.train_data_subsets[self.current_object_idx]
            paths = self.image_paths[scene]
            placeholder_object_token = \
                self.lookup_object_to_placeholder_object_token[scene]
            idx = i % len(paths)
            image_path = Path(paths[idx])
            global_idx = self._subset_offsets[scene] + idx
        else:
            placeholder_object_token = (self.placeholder_object_tokens[0]
                                        if self.placeholder_object_tokens
                                        else None)
            idx = global_idx = i % self.num_images
            image_path = Path(self.image_paths[idx])
        example: Dict[str, Any] = {"image_idx": global_idx}
        ex_rng = np.random.default_rng((self.seed, self._epoch, int(i)))
        template = self.templates[int(ex_rng.integers(len(self.templates)))]

        if self.learnable_mode == 0:
            example["text"] = template.format(placeholder_object_token)
            example["input_ids_placeholder_view"] = np.int32(-1)
            example["input_ids_placeholder_object"] = np.int32(
                self.tokenizer.convert_tokens_to_ids(
                    placeholder_object_token))
        else:
            if self.camera_representation == "spherical":
                view_token = f"<view_{image_path.stem.split('___')[-1]}>"
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
        example["object_idx"] = np.int32(self.current_object_idx
                                         if self.learnable_mode == 3 else 0)

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
        """The base with the stochastic suffix on the host: the mode-0
        flip, the preset's pipeline and [-1, 1] scaling (HWC float32).
        The crop may change the size (the llff passthrough's bases keep
        their files' sizes; the JAX package asserts here that it does not,
        which its own llff runs with a crop fail)."""
        img = self._load_base(image_path)
        if self.learnable_mode == 0 and rng.uniform() < self.flip_p:
            img = img[:, ::-1]
        if self.augmentations is not None:
            img = apply_augmentations(np.ascontiguousarray(img),
                                      self.augmentations, rng)
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
    is a function of (seed, epoch), each example's draws of (seed, epoch,
    index) and mode 3's scene of the global batch counter, so the stream
    is a function of the batch position; start_batch fast-forwards to it.

    group_size (mode 3 with fused accumulation): each batch is
    batch_size / group_size contiguous groups, and the scene is drawn
    again before each group with the counter next_batch * groups + g, so a
    fused batch carries the per-micro-batch scenes of the reference; the
    collated object_idx is then (G,). Without it, mode 3 draws the scene
    once per batch."""

    def __init__(self, dataset: TextualInversionDataset, batch_size: int,
                 seed: int = 0, start_batch: int = 0,
                 group_size: Optional[int] = None):
        if group_size and batch_size % group_size:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"group_size {group_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.group_size = group_size
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
        gs = self.group_size or self.batch_size
        groups = self.batch_size // gs
        mode3 = self.dataset.learnable_mode == 3
        for b in range(first, bpe):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            examples = []
            for g in range(groups):
                if mode3:
                    self.dataset.reset_sampled_object(
                        counter=(self._next_batch * groups + g
                                 if self.group_size else self._next_batch))
                examples += [self.dataset[int(i)]
                             for i in idxs[g * gs:(g + 1) * gs]]
            self._next_batch += 1
            yield self._collate(examples, self.group_size)

    @staticmethod
    def _collate(examples: List[Dict[str, Any]],
                 group_size: Optional[int] = None) -> Dict[str, Any]:
        batch = {}
        keys = ("input_ids", "input_ids_placeholder_object",
                "input_ids_placeholder_view")
        if "pixel_values" in examples[0]:
            keys = ("pixel_values",) + keys
        for k in keys:
            batch[k] = np.stack([e[k] for e in examples])
        if group_size:
            batch["object_idx"] = np.asarray(
                [e["object_idx"] for e in examples[::group_size]], np.int32)
        else:
            batch["object_idx"] = np.asarray(examples[0]["object_idx"])
        batch["image_idxs"] = np.asarray([e["image_idx"] for e in examples],
                                         np.int32)
        batch["texts"] = [e["text"] for e in examples]
        return batch
