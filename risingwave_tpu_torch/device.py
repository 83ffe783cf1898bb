"""Device selection for the port's entry points.

Every generator and executor that owns tensors takes `device`, which
defaults to "cuda". A missing card is an error, never a silent move to
the CPU: the caller who wants the CPU (the differential tests) says so.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "risingwave_tpu_torch: device 'cuda' requested but no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        if dev.index is None:
            # tensors report an indexed device; compare like with like
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
