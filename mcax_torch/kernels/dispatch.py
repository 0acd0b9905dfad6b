"""Device resolution and the one dispatch rule of the port.

``mcax/kernels/dispatch.py`` picks a backend per kernel family from
``MCAX_*`` environment variables.  The port has no such knob and reads no
environment variable: a kernel wrapper looks only at the device of the
tensors it is given.

  * CPU tensors get the kernel's plain PyTorch version (the tests' path).
  * CUDA tensors get the hand-written CUDA kernel, or an exception: there is
    no fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the current CUDA card by default.

    Raises when no card is visible and the caller did not ask for the CPU
    explicitly, so a run never lands on the plain versions by accident."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; mcax_torch runs on the card by "
                "default — pass device='cpu' to run the plain PyTorch "
                "versions of its kernels")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "visible")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"mcax_torch runs on cuda or cpu, got {dev}")
    return dev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises for mixed or other devices."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different cards: "
                             f"{sorted({str(t.device) for t in tensors})}")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on one CUDA card or all on "
                     f"the CPU, got {sorted({str(t.device) for t in tensors})}")
