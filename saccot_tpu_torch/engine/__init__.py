from saccot_tpu_torch.engine.sac_cot import (  # noqa: F401
    RegistrationResult, register_batch, register_pair,
)
from saccot_tpu_torch.engine.svd3 import umeyama  # noqa: F401
