"""DTU helpers: camera <-> token codec, the train splits, file names and
the calibration reader.

The port's own copy of the matching parts of view_neti_tpu/data/dtu.py
(host-side numpy; this layer never touches the accelerator).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from view_neti_tpu_torch.constants import DTU_SPLIT_IDXS, PATH_DTU_CALIBRATION_DIR
from view_neti_tpu_torch.utils.codec import num_to_string, string_to_num


def dtu_get_train_idxs(dtu_subset: int) -> List[int]:
    """Camera indices included in training for a given subset key.

    0 -> full split (train + test idxs); 1/3/6 -> prefixes of the RegNeRF
    9-camera train split; 9 -> all 9; -1/-2/-3 -> medium-pitch ranges
    (reference training/dataset.py:321-356).
    """
    if dtu_subset == 0:
        return DTU_SPLIT_IDXS['train'] + DTU_SPLIT_IDXS['test']
    if dtu_subset == 1:
        return DTU_SPLIT_IDXS['train'][:1]
    if dtu_subset == 3:
        return DTU_SPLIT_IDXS['train'][:3]
    if dtu_subset == 6:
        return DTU_SPLIT_IDXS['train'][:6]
    if dtu_subset == 9:
        return list(DTU_SPLIT_IDXS['train'])
    if dtu_subset == -1:
        return list(range(12, 36))
    if dtu_subset == -2:
        return list(range(12, 36, 2))
    if dtu_subset == -3:
        return list(range(12, 36, 3))
    raise NotImplementedError(f"unknown dtu_subset {dtu_subset}")


def dtu_filter_fnames_lighting(image_paths: Sequence[Path],
                               dtu_lighting: str) -> List[Path]:
    """Keep only one lighting condition (field 3 of rect_CCC_L_r5000.png)."""
    return [f for f in image_paths
            if Path(f).stem.split("_")[2] == str(dtu_lighting)]


def dtu_cam_info_from_fname(fname: Union[str, Path]) -> Tuple[int, str]:
    """(cam_idx, lighting_idx) from a DTU filename. Filenames are
    1-indexed; the returned cam_idx is 0-indexed."""
    stem = Path(fname).stem
    cam_idx, lighting_idx = stem.split("_")[1:3]
    return int(cam_idx) - 1, lighting_idx


def dtu_cam_and_lighting_to_fname(cam_idx: int, lighting_idx: str) -> str:
    """Inverse of dtu_cam_info_from_fname (re-applies the 1-index shift)."""
    return f"rect_{cam_idx + 1:03d}_{lighting_idx}_r5000.png"


def dtu_filter_image_paths_from_idx(image_paths: Sequence[Path],
                                    idxs: Sequence[int]) -> List[Path]:
    """Filter to the given 0-indexed camera idxs, sorted by camera index."""
    idxs = set(idxs)
    kept = [f for f in image_paths if dtu_cam_info_from_fname(f)[0] in idxs]
    return sorted(kept, key=lambda f: dtu_cam_info_from_fname(f)[0])


def dtu_cam_params_to_token(cam_params: np.ndarray,
                            cam_key: Union[int, str] = 'NULL') -> str:
    """12-float camera (3x4 projective matrix) -> view token string.

    Format: <view_dtu12d_cam{key}_{n0}_{n1}_..._{n11}> with numbers encoded
    via num_to_string(tol=4) (reference training/dataset.py:455-468).
    """
    cam_params = np.asarray(cam_params, dtype=np.float64).flatten()
    assert len(cam_params) == 12
    return (f"<view_dtu12d_cam{cam_key}_"
            + "_".join(num_to_string(float(n), tol=4) for n in cam_params)
            + ">")


def dtu_token_to_cam_params(view_token: str, cam_idx_as_int: bool = False
                            ) -> Tuple[np.ndarray, Union[int, str]]:
    """Inverse of dtu_cam_params_to_token: (12,) float32 params + cam key."""
    cam_idx: Union[int, str] = view_token.split("_")[2][3:]
    if cam_idx_as_int:
        cam_idx = int(cam_idx)
    cam_params = np.asarray(
        [string_to_num(n) for n in view_token[:-1].split("_")[3:]],
        dtype=np.float32)
    return cam_params, cam_idx


def read_calibration_file(file_path: Union[str, Path]) -> np.ndarray:
    """Read a DTU cal18 3x4 projection matrix text file."""
    with open(file_path) as f:
        rows = [[float(num) for num in line.strip().split()]
                for line in f if line.strip()]
    return np.asarray(rows, dtype=np.float32)


def dtu_generate_dset_cam_tokens_params(
        calibration_dir: Union[str, Path] = PATH_DTU_CALIBRATION_DIR
) -> Tuple[Dict[int, str], Dict[int, np.ndarray]]:
    """Lookups camidx -> view token / camera params over all DTU cameras.

    Calibration filenames are 1-indexed (pos_NNN.txt); keys are 0-indexed
    (reference training/dataset.py:490-514).
    """
    fnames = sorted(p for p in Path(calibration_dir).iterdir()
                    if p.suffix == ".txt")
    lookup_camidx_to_cam_params: Dict[int, np.ndarray] = {}
    lookup_camidx_to_view_token: Dict[int, str] = {}
    for f in fnames:
        cam_key = int(f.stem.split("_")[1]) - 1
        assert cam_key not in lookup_camidx_to_cam_params, f"dup key {cam_key}"
        cam_params = read_calibration_file(f)
        lookup_camidx_to_cam_params[cam_key] = cam_params
        lookup_camidx_to_view_token[cam_key] = dtu_cam_params_to_token(
            cam_params, cam_key)
    return lookup_camidx_to_view_token, lookup_camidx_to_cam_params


def dtu_cam_bounds(lookup_camidx_to_cam_params: Dict[int, np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-dimension (12,) min/max over *all* dataset cameras.

    Used to normalize camera params to (-1, 1); computed over the full
    camera set (not just the training views) so ranges stay consistent when
    reusing pretrained view mappers (reference models/neti_mapper.py:276-284).
    """
    all_cams = np.stack([np.asarray(v).flatten()
                         for v in lookup_camidx_to_cam_params.values()])
    return all_cams.min(0), all_cams.max(0)
