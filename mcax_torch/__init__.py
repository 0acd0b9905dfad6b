"""mcax_torch — the PyTorch/CUDA port of mcax for NVIDIA Hopper (H100).

The JAX package ``mcax`` is the reference; this package mirrors its module
layout file for file and imports nothing of it (nor JAX).  Plain tensor code
is PyTorch; every kernel that ``mcax`` wrote in Pallas for the TPU is a CUDA
C++ kernel written by hand for ``sm_90a`` (``csrc/``), built with ``nvcc`` at
first use and bound through ``ctypes`` (``kernels/_build.py``).

Entry points run on the card: ``Pipeline(cfg)`` resolves to ``cuda`` and
raises when no card is visible, unless the caller passes ``device="cpu"``,
where every kernel's plain PyTorch version runs instead.

Layer map (as in mcax):
  kernels/   the CUDA kernels' wrappers, each beside its plain version.
  frames/    windowing, framing, STFT/iSTFT, overlap-add.
  algos/     GCC-PHAT, SRP-PHAT, covariance, MVDR.
  pipeline   the config-driven streaming block processor.
  dist/      the sharded pipeline over a time x channel mesh of processes.
  io/        WAV read/write, the native block reader, the block feeder.
  utils/     checkpoints and per-block metrics.
  cli/       ``python -m mcax_torch.cli.run``: WAV in; DOA, audio, metrics
             out.
"""

import torch

from mcax_torch import config as config
from mcax_torch import geometry as geometry
from mcax_torch.version import __version__ as __version__

# Every product on the path is fp32, as on the reference's CPU path: TF32
# keeps ~3 decimal digits, which the parity bounds do not allow.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
