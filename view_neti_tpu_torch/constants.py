"""Framework-wide constants: the port's own copy of the part of
view_neti_tpu/constants.py that the serving slice reads (values, not
code, of the original ViewNeTI constants module)."""

# The 16 cross-attention layers of the SD UNet, in invocation order.
# (reference constants.py:1-4). The TPU rebuild threads a stacked
# (16, B, 77, D) context tensor through the UNet and indexes it with a
# *static* per-layer id in this order, replacing the reference's mutable
# `this_idx` counter.
UNET_LAYERS = [
    'IN01', 'IN02', 'IN04', 'IN05', 'IN07', 'IN08', 'MID', 'OUT03', 'OUT04',
    'OUT05', 'OUT06', 'OUT07', 'OUT08', 'OUT09', 'OUT10', 'OUT11'
]

NUM_UNET_LAYERS = len(UNET_LAYERS)

# DTU dataset layout (reference constants.py:13-31).
PATH_DTU_CALIBRATION_DIR = "data/dtu/Calibration/cal18"

# RegNeRF's IDR object masks of the DTU test scans (reference
# constants.py; view_neti_tpu/constants.py:44).
DTU_MASKS = "data/dtu/submission_data/idrmasks"

# RegNeRF camera splits. 0-indexed; DTU filenames are 1-indexed.
DTU_TRAIN_IDX = [25, 22, 28, 40, 44, 48, 0, 8, 13]
DTU_EXCLUDE_IDX = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]
DTU_TEST_IDX = [
    i for i in range(49) if i not in DTU_TRAIN_IDX + DTU_EXCLUDE_IDX
]
DTU_SPLIT_IDXS = {'test': DTU_TEST_IDX, 'train': DTU_TRAIN_IDX}

# Default validation prompts (reference constants.py:37-42).
VALIDATION_PROMPTS = [
    "A photo of a {}",
    "A photo of a {} on a beach",
    "App icon of {}",
    "A painting of {} in the style of Monet",
]

# Free-text objects of mode 3's view-generalisation sheet (reference
# validate.py:268-314; view_neti_tpu/constants.py:74).
T2I_GENERALIZATION_PROMPTS = [
    "a koala", "a brown teddy bear", "a small red car",
    "a small townhouse", "3 cans of soup", "a black dog",
]

# Textual-inversion caption templates (reference training/dataset.py,
# from the diffusers textual_inversion example).
IMAGENET_TEMPLATES_SMALL = [
    "a photo of a {}",
    "a rendering of a {}",
    "a cropped photo of the {}",
    "the photo of a {}",
    "a photo of a clean {}",
    "a photo of a dirty {}",
    "a dark photo of the {}",
    "a photo of my {}",
    "a photo of the cool {}",
    "a close-up photo of a {}",
    "a bright photo of the {}",
    "a cropped photo of a {}",
    "a photo of the {}",
    "a good photo of the {}",
    "a photo of one {}",
    "a close-up photo of the {}",
    "a rendition of the {}",
    "a photo of the clean {}",
    "a rendition of a {}",
    "a photo of a nice {}",
    "a good photo of a {}",
    "a photo of the nice {}",
    "a photo of the small {}",
    "a photo of the weird {}",
    "a photo of the large {}",
    "a photo of a cool {}",
    "a photo of a small {}",
]
