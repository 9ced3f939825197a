"""The augmentation presets (view_neti_tpu/data/augment.py:119-128).

One table serves ops/device_augment.py, which runs the presets on the card
inside the train step. The JAX package's host (PIL) pipeline for the same
presets, used only with data.device_augment false, is a later module of
the port.

Op order is fixed for every preset: jitter, grayscale, blur, rotation,
crop. Common parameters: jitter p = 0.75 with strength 0.04 x 4, blur
sigma (0.1, 0.2), rotation +-10 degrees with fill 1/255, crop p = 1 with
aspect ratio (3/4, 4/3) (reference training/dataset.py:238-316).
"""
AUGMENTATION_PRESETS = {
    1: dict(gray_p=0.1, blur_p=0.10, rot_p=0.75, crop_scale=(0.850, 1.15)),
    2: dict(gray_p=0.1, blur_p=0.10),
    3: dict(gray_p=0.1, blur_p=0.10, rot_p=0.75),
    4: dict(gray_p=0.1, blur_p=0.10, crop_scale=(0.850, 1.15)),
    5: dict(blur_p=0.25, crop_scale=(0.950, 1.05)),
    6: dict(gray_p=0.1, blur_p=0.10, rot_p=0.75, crop_scale=(0.70, 1.3)),
    7: dict(blur_p=0.2, rot_p=0.75, crop_scale=(0.70, 1.3)),
    8: dict(gray_p=0.1, blur_p=0.10),
}
