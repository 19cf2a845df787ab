from .vaegam import (  # noqa: F401
    COVARIATE_KEYS,
    MAP_KEYS,
    VAEGAMConfig,
    forward,
    gp_transforms,
    hrf_kernel,
    init_model,
    resolve_qu_S,
)
