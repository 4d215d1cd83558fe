"""Constants of the optical-flow workload (copied, not imported, from the
JAX package's ``consts.py``)."""

import numpy as np

#: HRV-only statistics used by the optical-flow pipeline
#: (reference notebook 13 cell 9: SAT_IMAGE_MEAN / SAT_IMAGE_STD).
SAT_IMAGE_MEAN = np.float32(93.23458)
SAT_IMAGE_STD = np.float32(115.34247)
