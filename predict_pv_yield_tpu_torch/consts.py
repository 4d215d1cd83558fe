"""Dataset-wide constants (copied, not imported, from the JAX package's
``consts.py``).

The per-channel satellite statistics are part of the on-disk data contract:
satellite imagery is stored as int16 counts and decoded to float32 via
``(x - SAT_MEAN[c]) / SAT_STD[c]``.
"""

import numpy as np

#: The 12 EUMETSAT SEVIRI channels, HRV first.
SAT_VARIABLE_NAMES = (
    "HRV",
    "IR_016",
    "IR_039",
    "IR_087",
    "IR_097",
    "IR_108",
    "IR_120",
    "IR_134",
    "VIS006",
    "VIS008",
    "WV_062",
    "WV_073",
)

#: UK Met Office UKV NWP channels.
NWP_VARIABLE_NAMES = ("t", "dswrf", "prate", "r", "sde", "si10", "vis", "lcc", "mcc", "hcc")

#: Per-channel mean of raw int16 satellite counts, aligned with
#: SAT_VARIABLE_NAMES.
SAT_MEAN = np.array(
    [
        93.23458,
        131.71373,
        843.7779,
        736.6148,
        771.1189,
        589.66034,
        862.29816,
        927.69586,
        90.70885,
        107.58985,
        618.4583,
        532.47394,
    ],
    dtype=np.float32,
)

#: Per-channel std of raw int16 satellite counts.
SAT_STD = np.array(
    [
        115.34247,
        139.92636,
        36.99538,
        57.366386,
        30.346825,
        149.68007,
        51.70631,
        35.872967,
        115.77212,
        120.997154,
        98.57828,
        99.76469,
    ],
    dtype=np.float32,
)

#: HRV-only statistics used by the optical-flow pipeline
#: (reference notebook 13 cell 9: SAT_IMAGE_MEAN / SAT_IMAGE_STD).
SAT_IMAGE_MEAN = np.float32(93.23458)
SAT_IMAGE_STD = np.float32(115.34247)

#: Number of PV systems per example in a prepared batch.
N_PV_SYSTEMS_PER_EXAMPLE = 128

#: Number of GSPs per example in a prepared batch.
N_GSPS_PER_EXAMPLE = 32

#: Size of the system-ID embedding table of the conv3d family.
N_PV_SYSTEM_IDS = 940
