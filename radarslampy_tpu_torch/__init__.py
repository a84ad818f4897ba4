"""radarslampy_tpu_torch — the PyTorch/CUDA port of radarslampy_tpu.

The driver (`RadarSlamSystem(...).run()`, `python -m radarslampy_tpu_torch`)
and the per-frame odometry step (`models.frontend.init_state` / `slam_step` /
`slam_step_chunk`) run on an NVIDIA GPU; the step's one TPU kernel, the DoH
scale space, is a hand-written CUDA kernel (`csrc/doh.cu`, bound in
`ops/cuda/doh_cuda.py`).  The package imports torch, numpy, the standard
library and (to decode PNGs) PIL only — never JAX and never `radarslampy_tpu`.

Precision: TF32 is switched off for matmuls and cuDNN convolutions on import.
The determinant of Hessian subtracts near-equal products and scales them by
sigma^4 (up to 1e4); at TF32's ~3 significant digits that loses a large part
of the DoH signal (the JAX package runs the same blurs at HIGHEST precision
for the same reason, `radarslampy_tpu/ops/features.py`).

Device: entry points take `device=` and default to "cuda".  Without a CUDA
device they raise unless the caller asks for "cpu" explicitly.
"""

from __future__ import annotations

import torch

from radarslampy_tpu_torch.config import DEFAULT_CONFIG, SlamConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on; raises if CUDA is asked for
    and absent (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


# Imported after resolve_device: models.frontend, which the driver imports,
# takes resolve_device from this package.
from radarslampy_tpu_torch.models.system import RadarSlamSystem, RunResult  # noqa: E402

__all__ = ["SlamConfig", "DEFAULT_CONFIG", "RadarSlamSystem", "RunResult", "resolve_device"]
__version__ = "0.1.0"
