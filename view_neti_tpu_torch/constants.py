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

# RegNeRF camera splits. 0-indexed; DTU filenames are 1-indexed.
DTU_TRAIN_IDX = [25, 22, 28, 40, 44, 48, 0, 8, 13]
DTU_EXCLUDE_IDX = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]
DTU_TEST_IDX = [
    i for i in range(49) if i not in DTU_TRAIN_IDX + DTU_EXCLUDE_IDX
]
DTU_SPLIT_IDXS = {'test': DTU_TEST_IDX, 'train': DTU_TRAIN_IDX}
