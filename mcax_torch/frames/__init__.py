from mcax_torch.frames import ola as ola
from mcax_torch.frames import stft as stft
from mcax_torch.frames import window as window
from mcax_torch.frames.ola import overlap_add, streaming_overlap_add
from mcax_torch.frames.window import cola_error, hann, make_windows, sqrt_hann
from mcax_torch.frames import filters as filters
