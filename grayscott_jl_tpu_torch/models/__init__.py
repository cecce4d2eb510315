"""Model registry (counterpart of ``grayscott_jl_tpu/models``).
Importing this package registers the built-in models: ``grayscott``
(the flagship), ``brusselator``, ``fhn`` and ``heat``; the kernel
generator (``ops/kernelgen.py``) gives each its CUDA kernel.
"""

from __future__ import annotations

from .base import (  # noqa: F401
    FRAMEWORK_PARAMS,
    Model,
    SettingsError,
    available_models,
    get_model,
    register,
    seeded_box_init,
)

from . import grayscott  # noqa: F401,E402
from . import brusselator  # noqa: F401,E402
from . import fhn  # noqa: F401,E402
from . import heat  # noqa: F401,E402
